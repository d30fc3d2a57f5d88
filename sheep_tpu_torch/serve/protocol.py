"""The serve wire protocol: one line in, one line out, always typed.

Line-oriented text over a stream socket — trivially speakable from any
language, ``nc``, or a shell heredoc, and every response is a SINGLE line
so a reader never blocks mid-response.  Requests::

    [DEADLINE=<seconds>] [RID=<hex>] VERB [args...]

Prefix tokens may appear in any order before the verb:
``DEADLINE=`` is the per-request deadline (below), ``RID=`` is the
trace-context id the router stamps so every process a request crosses
records joinable spans (obs/merge.py), and UNKNOWN ``KEY=`` prefix
tokens are skipped silently — a newer router may stamp tokens this
daemon has never heard of and the request must still parse.  Requests
carrying no prefix tokens are byte-identical to the tokenless grammar.

    PART v [v...]        -> OK p [p...]          (-1 = vertex has no part)
    PARENT v [v...]      -> OK t [t...]   (t = <vid> | root | absent;
                            single-vid responses as before batches)
    SUBTREE v            -> OK size=<n> pst=<w>
    SUBTREE v v [v...]   -> OK s:w [s:w...]      (absent = vid not in the
                            sequence; batches answer positionally, only
                            the single-vid form refuses typed notfound)
    TENANT [name]        -> OK tenant=<name>     (connection-scoped
                            selector, re-points THIS
                            connection's verbs at another hosted
                            tenant; with no arg reports the selection)
    EVICT name           -> OK tenant=<name> resident=0  (seal the
                            tenant to its snapshot + drop from memory;
                            next touch lazily restores)
    ECV                  -> OK ecv_down=<n> baseline=<n> drift_cut=<n>
                            parts=<k>
    INSERT u v [u v...]  -> OK seq=<wal seqno> applied=<k>
    STATS                -> OK key=value ...  (role/epoch/lag, plus the
                            per-verb req_* counts and p50_*/p99_* request
                            latencies derived from the metrics registry)
    METRICS              -> OK bytes=<n>, followed by <n> raw bytes of
                            Prometheus text exposition format (counters,
                            gauges, per-verb latency histograms —
                            obs/metrics.py; the snapshot-transfer shape:
                            one header line + length-prefixed payload)
    SNAPSHOT             -> OK snap=<filename>
    MIG OP tenant [k=v]  -> migration plumbing (the router's
                            MIGRATE verb drives these on the two
                            leaders): ADOPT bootstraps + delta-streams
                            the tenant here, SEAL fences the source
                            (``ERR moved dest=``), CUT advances the
                            target's tenant epoch durably before its
                            first write, UNSEAL aborts back to source,
                            DROP discards an adopted copy, STAT reports
                            phase/lag
    REPARTITION          -> OK parts=<k> baseline=<n>
    PING                 -> OK pong
    QUIT                 -> OK bye (connection closes)

Replication speaks the same line grammar under one verb; see
serve/replicate.py for the frame codec and the stream lifecycle::

    REPL HELLO node=<id> epoch=<e> seqno=<s> sig=<sig>
        -> OK mode=stream epoch=<E> seqno=<S>     (conn becomes a stream)
        -> OK mode=snapshot bytes=<n> seqno=<S> epoch=<E> crc=<c>
           followed by <n> raw snapshot bytes, then the stream
    REPL SNAPSHOT [tenant=<t>]
                         -> OK bytes=<n> seqno=<S> epoch=<E> crc=<c>
                            sig=<sig>, followed by <n> raw bytes
                            (bootstrap fetch; conn stays line-mode)
    REPL VOTE epoch=<e> candidate=<id> seqno=<s>
                         -> OK grant=0|1 epoch=<mine> node=<me>
                            (quorum-vote election ballot:
                            one grant per epoch per voter; conn stays
                            line-mode.  HELLO takes tenant=<t> too —
                            one stream per tenant per follower.)
    leader -> follower stream frames (one line each):
        REPL APPEND epoch=<E> seqno=<n> crc=<c> data=<base64>
        REPL PING epoch=<E> seqno=<S>
    follower -> leader on the stream connection:
        REPL ACK seqno=<n>        (everything <= n durable + applied here)
        REPL NACK expect=<n>      (gap/corrupt frame; re-stream from n)
        REPL FENCED epoch=<e>     (your term is over: I live in epoch e)

``DEADLINE=`` overrides the daemon's default per-request deadline; a
request that cannot finish inside it gets ``ERR timeout ...`` — a typed
refusal, never a silent stall (the client's clock is the one that
matters, so the server refuses rather than answers late).

Errors are ``ERR <code> <message>`` with codes::

    badreq      unparseable request (client bug)
    timeout     deadline exceeded (typed timeout refusal)
    overload    admission shed this request (retry with backoff)
    readonly    inserts refused: explicit flag or memory pressure
    notfound    the named vertex is not in the sequence
    notleader   this node is a follower; the payload is the leader's
                ``host:port`` (or ``-`` while unknown) — writes redirect
                there instead of splitting the brain
    moved       the tenant has been migrated away: the
                payload carries ``dest=<cluster>`` naming the new home.
                A router re-resolves the tenant's placement and replays
                the request there — the same retry shape as notleader.
                Never a silent drop: a fenced source REFUSES so no
                write can land on a tenant that lives elsewhere
    stale       this follower's replication lag exceeds the configured
                bound (SHEEP_SERVE_MAX_LAG); reads refuse rather than
                silently answer from the past
    fenced      a replication peer spoke with a LATER epoch: this
                node's term is over and it is demoting
    badrepl     a replication handshake/frame this node cannot honor
                (sig mismatch, unparseable frame)
    unavailable a dependency is missing (no graph edges for ECV; the
                disk refused a WAL append or snapshot; a replication
                quorum did not acknowledge in time)
    internal    unexpected server-side failure (bug; logged server-side)

PART and INSERT batch naturally: many vertices / edge pairs per line, one
round-trip.  :class:`ServeClient` is the reference client used by the
tests, the tier-1 smoke, and scripts/servebench.py.
"""

from __future__ import annotations

import socket
import time
from dataclasses import dataclass, field

#: verbs that read state (admission kind "query"); TENANT is the
#: connection-scoped selector and never holds a slot.  CRC
#: answers the tenant's state_crc at its applied seqno — the
#: anti-entropy comparison point benches and smokes key divergence on
QUERY_VERBS = ("PART", "PARENT", "SUBTREE", "ECV", "STATS", "METRICS",
               "PING", "TENANT", "CRC")
#: verbs that mutate state (admission kind "insert", shed first)
INSERT_VERBS = ("INSERT",)
#: operator verbs (admitted as queries; SNAPSHOT/REPARTITION do their own
#: locking in the core, EVICT seals a cold tenant out of memory).  MIG
#: is the daemon-side migration surface the router's MIGRATE
#: verb drives: ``MIG ADOPT|SEAL|UNSEAL|CUT|DROP|STAT <tenant> [k=v...]``.
#: RESEQ forces the crash-safe re-sequence rebuild the
#: sequence-drift detector would otherwise trigger on its own.  SCRUB
#: forces one inline anti-entropy pass over the tenant's
#: sealed artifacts; CORRUPT flips one live byte (refused unless
#: SHEEP_SCRUB_ALLOW_CORRUPT=1 — a bench/test-only divergence injector)
ADMIN_VERBS = ("SNAPSHOT", "REPARTITION", "RESEQ", "SCRUB", "CORRUPT",
               "EVICT", "MIG", "QUIT")
#: the replication family (serve/replicate.py): handled OUTSIDE admission
#: — a configured replica is cluster plumbing, not client load, and
#: shedding it would turn an overload into a lag spiral
REPL_VERBS = ("REPL",)
#: the build-worker wire (serve/worker.py): LEG ships a distext
#: leg's slice to a ``sheep worker`` daemon, BEAT is the worker's wire
#: heartbeat back.  Spoken only between a distext supervisor and worker
#: daemons (which also answer PING/METRICS/QUIT in the shared grammar) —
#: a serve daemon refuses them like any unknown verb
WORKER_VERBS = ("LEG", "BEAT")

#: protocol line-length cap: a request that does not fit is a bad request,
#: not an invitation to buffer without bound
MAX_LINE = 1 << 20


class BadRequest(Exception):
    """Unparseable request line; maps to ``ERR badreq``."""


class DeadlineExceeded(Exception):
    """The request ran past its deadline; maps to ``ERR timeout``."""


@dataclass
class Request:
    verb: str
    args: list[str] = field(default_factory=list)
    deadline_s: float | None = None  # None: the daemon default applies
    rid: str | None = None           # trace-context id (RID= prefix token)

    @property
    def kind(self) -> str:
        return "insert" if self.verb in INSERT_VERBS else "query"


#: rid charset: hex (what routers mint) plus ``-`` so foreign tracing
#: systems can forward their ids; anything else is a typed badreq
#: (compiled: per-request validation must price like a token)
import re as _re
_RID_RE = _re.compile(r"[0-9a-fA-F-]{1,64}\Z")
MAX_RID_LEN = 64


def split_prefix_tokens(toks: list[str]):
    """The optional-prefix grammar: leading ``KEY=value``
    tokens (KEY alphabetic) precede the verb.  ``DEADLINE=`` and
    ``RID=`` are understood; UNKNOWN keys are skipped silently — a
    newer router may stamp tokens this daemon has never heard of, and
    the request must still parse (the grammar is byte-identical for
    requests carrying no prefix tokens).  Returns ``(deadline, rid,
    verb_index)``; raises BadRequest for malformed known tokens."""
    deadline = None
    rid = None
    i = 0
    for i, tok in enumerate(toks):
        eq = tok.find("=")
        if eq <= 0:
            return deadline, rid, i
        key = tok[:eq]
        if not (key.isascii() and key.isalpha()):
            return deadline, rid, i
        val = tok[eq + 1:]
        key = key.upper()
        if key == "DEADLINE":
            try:
                deadline = float(val)
            except ValueError:
                raise BadRequest(f"unparseable deadline {val!r}")
            if deadline < 0:
                raise BadRequest(f"negative deadline {val!r}")
        elif key == "RID":
            if _RID_RE.match(val) is None:
                raise BadRequest(f"unparseable request id {val!r}")
            rid = val
        # any other KEY= prefix token: ignored (forward compatibility)
    return deadline, rid, len(toks)


def parse_request(line: str) -> Request:
    toks = line.split()
    if not toks:
        raise BadRequest("empty request")
    deadline, rid, i = split_prefix_tokens(toks)
    toks = toks[i:]
    if not toks:
        raise BadRequest("prefix token(s) with no request")
    verb = toks[0].upper()
    if verb not in QUERY_VERBS + INSERT_VERBS + ADMIN_VERBS + REPL_VERBS:
        raise BadRequest(f"unknown verb {toks[0]!r}")
    return Request(verb=verb, args=toks[1:], deadline_s=deadline,
                   rid=rid)


def parse_kv_args(args: list[str]) -> dict:
    """``key=value`` argument tokens -> dict (REPL frames, HELLO)."""
    out = {}
    for tok in args:
        k, sep, v = tok.partition("=")
        if not sep or not k:
            raise BadRequest(f"expected key=value, got {tok!r}")
        out[k] = v
    return out


def parse_vids_batch(args: list[str]):
    """The vectorized vid-list decode: one numpy parse of the
    whole token list instead of a Python int() loop — the front half of
    the batched-verb fast path (state.part_batch is the back half).

    Errors carry the EXACT offending token and its 0-based position, and
    every bad batch is a typed ``ERR badreq`` with nothing answered —
    the same all-or-nothing contract as the scalar parser."""
    if not args:
        raise BadRequest("expected vertex ids")
    import numpy as np
    try:
        vids = np.array(args, dtype=np.int64)
    except (ValueError, OverflowError):
        # slow path: name the exact bad token, or clamp a valid-but-
        # oversized id (any id past int64 is outside every table, so it
        # answers the same absent sentinel the scalar path gave it)
        vids = np.empty(len(args), dtype=np.int64)
        for i, a in enumerate(args):
            try:
                v = int(a)
            except ValueError:
                raise BadRequest(
                    f"non-integer vertex id {a!r} at position {i}")
            if v < 0:
                raise BadRequest(
                    f"negative vertex id {args[i]} at position {i}")
            vids[i] = min(v, (1 << 63) - 1)
        return vids
    neg = np.flatnonzero(vids < 0)
    if neg.size:
        i = int(neg[0])
        raise BadRequest(f"negative vertex id {args[i]} at position {i}")
    return vids


def parse_vids(args: list[str], want_pairs: bool = False) -> list[int]:
    if not args:
        raise BadRequest("expected vertex ids")
    try:
        vids = [int(a) for a in args]
    except ValueError:
        raise BadRequest(f"non-integer vertex id in {args!r}")
    if any(v < 0 for v in vids):
        raise BadRequest("negative vertex id")
    if want_pairs and len(vids) % 2:
        raise BadRequest(f"INSERT wants u v pairs, got {len(vids)} ids")
    return vids


def ok_line(*fields) -> str:
    return " ".join(["OK"] + [str(f) for f in fields])


def ok_kv(**kv) -> str:
    return "OK " + " ".join(f"{k}={v}" for k, v in kv.items())


def err_line(code: str, msg: str) -> str:
    return f"ERR {code} " + " ".join(str(msg).split())


class ServeError(RuntimeError):
    """Client-side face of an ``ERR`` response."""

    def __init__(self, code: str, msg: str):
        super().__init__(f"{code}: {msg}")
        self.code = code
        self.detail = msg


class ServeClient:
    """Minimal blocking client for one connection.

    ``request`` returns the raw response line; the typed helpers raise
    :class:`ServeError` on ``ERR`` so tests and scripts cannot mistake a
    refusal for data.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout_s)
        self._rf = self.sock.makefile("rb")

    def close(self) -> None:
        try:
            self._rf.close()
        finally:
            self.sock.close()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def request(self, line: str) -> str:
        self.sock.sendall(line.encode("ascii") + b"\n")
        resp = self._rf.readline()
        if not resp:
            raise ConnectionError("server closed the connection "
                                  "(killed mid-request?)")
        return resp.decode("ascii").rstrip("\n")

    def _ok(self, line: str) -> list[str]:
        resp = self.request(line)
        toks = resp.split()
        if not toks or toks[0] != "OK":
            if toks and toks[0] == "ERR":
                raise ServeError(toks[1] if len(toks) > 1 else "unknown",
                                 " ".join(toks[2:]))
            raise ServeError("protocol", f"unparseable response {resp!r}")
        return toks[1:]

    def ping(self) -> None:
        self._ok("PING")

    def part(self, vids) -> list[int]:
        out = self._ok("PART " + " ".join(str(v) for v in vids))
        return [int(p) for p in out]

    def parent(self, vids) -> list:
        """Batched PARENT: per-vid parent vid, ``"root"``, or
        ``"absent"``."""
        out = self._ok("PARENT " + " ".join(str(v) for v in vids))
        return [t if t in ("root", "absent") else int(t) for t in out]

    def tenant(self, name: str) -> str:
        """Select ``name`` for every later verb on THIS connection."""
        out = self._ok(f"TENANT {name}")
        return dict(f.split("=", 1) for f in out)["tenant"]

    def insert(self, pairs) -> int:
        """pairs: iterable of (u, v); returns the batch's WAL seqno."""
        flat = " ".join(f"{int(u)} {int(v)}" for u, v in pairs)
        out = self._ok("INSERT " + flat)
        return int(dict(f.split("=", 1) for f in out)["seq"])

    def metrics(self) -> str:
        """``METRICS`` -> the Prometheus text scrape body (the header's
        ``bytes=`` count covers the payload including its final
        newline)."""
        out = self._ok("METRICS")
        n = int(dict(f.split("=", 1) for f in out)["bytes"])
        data = b""
        while len(data) < n:
            chunk = self._rf.read(n - len(data))
            if not chunk:
                raise ConnectionError("server closed mid-METRICS payload")
            data += chunk
        return data.decode("ascii")

    def kv(self, verb: str) -> dict:
        """STATS / ECV / REPARTITION-style key=value responses."""
        out = self._ok(verb)
        rec = {}
        for f in out:
            k, _, v = f.partition("=")
            try:
                rec[k] = int(v)
            except ValueError:
                rec[k] = v
        return rec


def connect_retry(host: str, port: int, timeout_s: float = 30.0,
                  poll_s: float = 0.05) -> ServeClient:
    """Connect + PING with retries — the 'wait for the daemon to come
    (back) up' helper the recovery tests and servebench time."""
    deadline = time.monotonic() + timeout_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            c = ServeClient(host, port, timeout_s=max(1.0, poll_s * 10))
            try:
                c.ping()
                return c
            except Exception:
                c.close()
                raise
        except (OSError, ServeError) as exc:
            last = exc
            time.sleep(poll_s)
    raise TimeoutError(f"serve daemon at {host}:{port} not answering "
                       f"after {timeout_s}s ({last})")
