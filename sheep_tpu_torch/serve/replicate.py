"""WAL shipping: the leader streams acked records to followers.

The WAL is already an ordered, checksummed, sig-fenced record
stream; replication ships exactly those records over the line
protocol and replays them through the exact insert path the leader ran —
so a follower is bit-identical by construction, the same way WAL replay
after a crash is.  The pieces:

  frame codec     one APPEND frame per WAL record — ascii line, base64
                  payload, crc32 over the RAW payload bytes (a frame
                  torn mid-line never parses; a frame corrupted in
                  flight fails its crc; both trigger re-sync, never a
                  partial apply)
  ReplApplier     the follower-side frame consumer.  Socket-free on
                  purpose: the torn-stream property test feeds it byte
                  prefixes directly (tests/test_replicate.py), the same
                  discipline as the WAL torn-tail sweep.
  ReplicationHub  the leader side: one sender thread per attached
                  follower, woken by ServeCore.on_append, double-
                  buffered in the Pipelined-Workflow sense — the leader
                  keeps acking local WAL appends while senders drain the
                  tail to followers concurrently.  Cumulative ACKs feed
                  the per-follower lag report and the insert quorum wait.
  Replicator      the follower's connection owner: discover the leader,
                  HELLO, stream (or snapshot-bootstrap when the leader's
                  WAL moved past us), reconnect on any failure.

Delivery contract: frames can be lost, duplicated, delayed, or the
connection cut at ANY byte (SHEEP_SERVE_NETFAULT_PLAN rehearses each) —
the seqno chain makes every case safe: duplicates drop idempotently,
gaps NACK a re-stream, and a follower only ever ACKs what is durable in
its OWN WAL.
"""

from __future__ import annotations

import base64
import binascii
import os
import socket
import threading
import time
import zlib

from ..integrity.errors import IntegrityError
from ..obs import trace
from . import netfaults
from .protocol import BadRequest, parse_kv_args
from .state import ReplicationGap, ServeCore, load_serve_snapshot
from .wal import MAX_PAYLOAD

#: replication stream heartbeat cadence (leader PING when idle) and the
#: socket read timeout followers derive from it
REPL_HB_ENV = "SHEEP_SERVE_REPL_HB_S"
DEFAULT_HB_S = 1.0
#: how long a follower waits for the leader's HELLO answer and the
#: snapshot behind it (the bootstrap fetch's default): a leader seals a
#: snapshot before it answers ``mode=snapshot``, which takes seconds on a
#: large store, so the stream's heartbeat-sized timeout would time the
#: answer out and every retry would seal again
HANDSHAKE_S = 60.0


class ReplProtocolError(RuntimeError):
    """A replication frame this node cannot honor (maps to badrepl)."""


class ResyncRequired(ReplProtocolError):
    """The leader's stream moved to a sequence generation this follower
    does not have (a RESEQ frame, or an APPEND carrying a foreign
    ``gen=``): the stream cannot continue record-by-record — the
    follower must re-HELLO and adopt the leader's re-sequenced snapshot
    as one unit.  Subclasses ReplProtocolError so every
    existing reconnect path already handles it."""


class Diverged(ReplProtocolError):
    """A VERIFY frame proved this follower's applied state differs from
    the leader's at the same seqno: silently corrupted state
    the seqno chain can never catch.  The applier has already entered
    the durable quarantine (serve/scrub.py) before raising; subclassing
    ReplProtocolError tears the stream through the existing reconnect
    path, where the Replicator's quarantine re-sync takes over."""


# -- frame codec ------------------------------------------------------------


def payload_crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def encode_append(epoch: int, seqno: int, payload: bytes,
                  rid: str | None = None, gen: int = 0) -> str:
    """One WAL record -> one APPEND frame line (no trailing newline).
    ``rid`` forwards the originating request's trace-context
    id so the follower's WAL fsync is attributable to it; the token is
    omitted when absent, and old daemons ignore it either way (kv-token
    grammar — unknown keys pass through parse_kv_args untouched).
    ``gen`` stamps the record with the leader's sequence
    generation; omitted at generation 0 so a never-re-sequenced stream
    stays byte-identical to the plain stream's.  A follower on a different generation
    trips :class:`ResyncRequired` — this is the belt under the RESEQ
    frame's suspenders: even if the announce is lost on the wire, the
    very next record forces the re-sync."""
    data = base64.b64encode(payload).decode("ascii")
    head = f"REPL APPEND epoch={epoch} seqno={seqno} " \
           f"crc={payload_crc(payload)}"
    if gen:
        head += f" gen={gen}"
    if rid is not None:
        head += f" rid={rid}"
    return f"{head} data={data}"


def encode_reseq(epoch: int, seqno: int, gen: int, sig: str) -> str:
    """The re-sequence announce: "everything after ``seqno``
    is generation ``gen`` under input signature ``sig``" — a sequenced
    barrier in the stream, never a partial apply.  A follower that is
    not already at ``gen`` must adopt the leader's snapshot."""
    return f"REPL RESEQ epoch={epoch} seqno={seqno} gen={gen} sig={sig}"


def encode_ping(epoch: int, seqno: int) -> str:
    return f"REPL PING epoch={epoch} seqno={seqno}"


def encode_verify(epoch: int, seqno: int, crc: int) -> str:
    """The anti-entropy checkpoint: "my state_crc at applied
    seqno ``seqno`` was ``crc``".  Stamped in-stream right after the
    APPEND it names, so a follower at the same position compares
    directly.  Only sent on streams whose HELLO advertised ``verify=1``
    — an old follower never sees the frame (forward compat by
    capability, not by tolerance)."""
    return f"REPL VERIFY epoch={epoch} seqno={seqno} crc={crc}"


def encode_hello(node: str, epoch: int, seqno: int, sig: str,
                 tenant: str | None = None, mig: bool = False,
                 verify: bool = False) -> str:
    """The stream handshake; ``tenant`` names a non-default tenant's
    stream and is omitted otherwise so the single-tenant
    handshake stays byte-identical to the plain stream's.  ``mig=1`` marks
    a MIGRATION delta stream: the leader files its APPENDs under the
    ``mdelta`` netfault site instead of ``repl`` so the migration wire
    is chaos-sweepable independently of ordinary replication.
    ``verify=1`` advertises that this follower understands
    VERIFY anti-entropy frames; a leader that predates them ignores the
    unknown token (kv grammar), a new leader only stamps VERIFY on
    streams that asked — either mixed-version pairing degrades to plain
    plain replication, never to a NACK storm."""
    line = f"REPL HELLO node={node} epoch={epoch} seqno={seqno} sig={sig}"
    if tenant is not None and tenant != "default":
        line += f" tenant={tenant}"
    if mig:
        line += " mig=1"
    if verify:
        line += " verify=1"
    return line


def encode_ack(seqno: int) -> str:
    """Cumulative: everything <= seqno is durable + applied here."""
    return f"REPL ACK seqno={seqno}"


def encode_nack(expect: int) -> str:
    return f"REPL NACK expect={expect}"


def encode_fenced(epoch: int) -> str:
    return f"REPL FENCED epoch={epoch}"


class ReplFrame:
    __slots__ = ("kind", "kv", "payload")

    def __init__(self, kind: str, kv: dict, payload: bytes | None = None):
        self.kind = kind
        self.kv = kv
        self.payload = payload

    def seqno(self) -> int:
        return int(self.kv["seqno"])

    def epoch(self) -> int:
        return int(self.kv["epoch"])


def parse_frame(line: str) -> ReplFrame:
    """Parse one ``REPL ...`` line into a typed frame; raises
    :class:`ReplProtocolError` on anything malformed (bad base64, crc
    mismatch, missing fields) — the caller re-syncs, it never guesses."""
    toks = line.split()
    if len(toks) < 2 or toks[0].upper() != "REPL":
        raise ReplProtocolError(f"not a replication frame: {line!r}")
    kind = toks[1].upper()
    try:
        kv = parse_kv_args(toks[2:])
    except BadRequest as exc:
        raise ReplProtocolError(f"bad {kind} frame: {exc}")
    payload = None
    if kind == "APPEND":
        for field in ("epoch", "seqno", "crc", "data"):
            if field not in kv:
                raise ReplProtocolError(f"APPEND frame missing {field}=")
        try:
            payload = base64.b64decode(kv["data"].encode("ascii"),
                                       validate=True)
        except (binascii.Error, ValueError) as exc:
            raise ReplProtocolError(f"APPEND frame payload is not valid "
                                    f"base64 ({exc})")
        if len(payload) > MAX_PAYLOAD:
            raise ReplProtocolError(
                f"APPEND frame claims {len(payload)} payload bytes "
                f"(cap {MAX_PAYLOAD})")
        try:
            want = int(kv["crc"])
        except ValueError:
            raise ReplProtocolError(f"APPEND frame crc {kv['crc']!r} is "
                                    f"not an integer")
        if payload_crc(payload) != want:
            raise ReplProtocolError(
                f"APPEND frame for seqno {kv.get('seqno')} fails its "
                f"crc32 — corrupted in flight")
    elif kind == "PING":
        for field in ("epoch", "seqno"):
            if field not in kv:
                raise ReplProtocolError(f"PING frame missing {field}=")
    elif kind == "ACK":
        if "seqno" not in kv:
            raise ReplProtocolError("ACK frame missing seqno=")
    elif kind == "NACK":
        if "expect" not in kv:
            raise ReplProtocolError("NACK frame missing expect=")
    elif kind == "RESEQ":
        for field in ("epoch", "seqno", "gen", "sig"):
            if field not in kv:
                raise ReplProtocolError(f"RESEQ frame missing {field}=")
    elif kind == "VERIFY":
        for field in ("epoch", "seqno", "crc"):
            if field not in kv:
                raise ReplProtocolError(f"VERIFY frame missing {field}=")
        try:
            if int(kv["crc"]) < 0:
                raise ValueError
        except ValueError:
            raise ReplProtocolError(
                f"VERIFY frame crc={kv['crc']!r} is not a non-negative "
                f"integer")
    elif kind in ("HELLO", "FENCED", "SNAPSHOT"):
        pass
    else:
        raise ReplProtocolError(f"unknown replication frame {kind!r}")
    for field in ("epoch", "seqno", "expect", "gen"):
        if field in kv:
            try:
                if int(kv[field]) < 0:
                    raise ValueError
            except ValueError:
                raise ReplProtocolError(
                    f"{kind} frame {field}={kv[field]!r} is not a "
                    f"non-negative integer")
    return ReplFrame(kind, kv, payload)


# -- follower side ----------------------------------------------------------


class ReplApplier:
    """Consume the leader's byte stream and apply complete, crc-valid
    frames to a follower core — nothing else, ever.

    Socket-free: ``feed`` takes raw bytes (any split), buffers the
    incomplete tail, and hands complete frames to the core; outbound
    ACK/NACK/FENCED lines go through the injected ``send`` callable.  A
    stream cut at ANY byte boundary leaves at most an incomplete line in
    the buffer — no partial record can reach the tree (property-swept in
    tests/test_replicate.py, mirroring the torn-WAL sweep).
    """

    def __init__(self, core: ServeCore, send, on_epoch=None,
                 on_diverged=None):
        self.core = core
        self._send = send
        #: adopt a later leader epoch (default: seal the boundary
        #: locally via core.advance_epoch)
        self._on_epoch = on_epoch or core.advance_epoch
        #: divergence hook: called with (seqno, want_crc,
        #: got_crc) AFTER the durable quarantine is entered, BEFORE the
        #: stream tears — the daemon bumps counters/events off it
        self.on_diverged = on_diverged
        self._buf = bytearray()
        self.leader_seqno = core.applied_seqno
        self.last_frame_t: float | None = None
        self.applied = 0
        self.dups = 0
        self.gaps = 0
        self.frame_errors = 0
        self.verifies = 0   # VERIFY checkpoints compared
        self.diverged = 0   # ... of which mismatched -> quarantine
        self.resyncs_required = 0  # generation breaks
        self.bursts = 0  # sealed APPEND bursts (one fsync + one ACK each)
        self._unsynced = False  # applied-but-unsynced records in the WAL
        self._ack_due = False   # an APPEND landed since the last ACK
        self._burst_rid: str | None = None  # newest rid in the open burst

    @property
    def lag(self) -> int:
        return max(0, self.leader_seqno - self.core.applied_seqno)

    def feed(self, data: bytes) -> None:
        """Buffer ``data`` and handle every COMPLETE line in it.

        APPEND frames that arrive together are applied as ONE durability
        burst (batched follower acks): each record appends to the local
        WAL with its fsync deferred, the burst seals with a SINGLE fsync,
        and one cumulative ACK answers the lot — the per-record fsync was
        the throughput cap on replicated inserts.  The ack invariant is
        unchanged: nothing is ACKed before it is durable in the local WAL
        (the seal's fsync strictly precedes the ACK), so a crash
        mid-burst loses only never-acknowledged records and recovery
        lands on a valid earlier record boundary.
        """
        self._buf.extend(data)
        lines = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break
            lines.append(bytes(self._buf[:nl]))
            del self._buf[: nl + 1]
        for i, raw in enumerate(lines):
            try:
                text = raw.decode("ascii").strip()
            except UnicodeDecodeError:
                self._seal_burst()
                self.frame_errors += 1
                self._send(encode_nack(self.core.applied_seqno + 1))
                continue
            if text:
                self.handle_line(text, defer_ack=i + 1 < len(lines))
        self._seal_burst()

    def _seal_burst(self) -> None:
        """fsync the burst's deferred WAL tail, then send ONE cumulative
        ACK.  No-op when nothing is pending.  A failed fsync propagates
        with nothing acked — the stream dies and the reconnect re-syncs
        from the durable position.  The seal's ``wal.fsync`` span
        carries the burst's NEWEST rid (a one-record burst — the common
        quorum-acked insert — is exactly attributed; multi-rid bursts
        attribute the seal to their last request, with every per-record
        rid still on the records' own apply spans)."""
        if self._unsynced:
            with trace.rid_scope(self._burst_rid):
                self.core.wal_sync()  # may raise: nothing gets acked
            self._unsynced = False
            self.bursts += 1
        self._burst_rid = None
        if self._ack_due:
            self._ack_due = False
            self._send(encode_ack(self.core.applied_seqno))

    def handle_line(self, text: str, defer_ack: bool = False) -> None:
        """Handle one frame line.  ``defer_ack`` marks a mid-burst APPEND
        (more complete lines are already buffered): its fsync+ACK are
        deferred to the burst seal.  Every other frame kind seals any
        open burst first, so an ACK for a PING can never cover an
        unsynced record."""
        self.last_frame_t = time.monotonic()
        try:
            frame = parse_frame(text)
        except ReplProtocolError:
            # a frame that parses wrong is indistinguishable from lost
            # bytes: ask for a re-stream from our applied position
            self._seal_burst()
            self.frame_errors += 1
            self._send(encode_nack(self.core.applied_seqno + 1))
            return
        if frame.kind not in ("APPEND", "PING", "RESEQ", "VERIFY"):
            return  # HELLO responses etc. are the Replicator's business
        epoch = frame.epoch()
        if epoch < self.core.epoch:
            # a fenced ex-leader is still streaming at us: tell it its
            # term is over instead of applying history that lost
            self._seal_burst()
            self._send(encode_fenced(self.core.epoch))
            return
        if epoch > self.core.epoch:
            self._seal_burst()  # the old epoch's tail seals under it
            self._on_epoch(epoch)
        self.leader_seqno = max(self.leader_seqno, frame.seqno())
        if frame.kind == "RESEQ":
            # the swap arrives as a sequenced unit: either we are
            # already on the announced generation (we adopted it via an
            # earlier snapshot re-sync) or the stream cannot continue —
            # a record-by-record replay across a re-sequence would be
            # exactly the half-swapped tree this frame exists to forbid
            self._seal_burst()
            gen = int(frame.kv["gen"])
            if self.core.seq_gen >= gen:
                self._send(encode_ack(self.core.applied_seqno))
                return
            self.resyncs_required += 1
            raise ResyncRequired(
                f"leader re-sequenced to generation {gen} (sig "
                f"{frame.kv['sig'][:12]}...); this follower is at "
                f"{self.core.seq_gen} — snapshot adoption required")
        if frame.kind == "VERIFY":
            # anti-entropy checkpoint: the leader's state_crc
            # at exactly this applied seqno.  Comparable only when we
            # are AT that seqno — after a NACK rewind the leader
            # re-streams records we already hold, and the re-sent VERIFY
            # lands while applied_seqno is ahead; skip it, the next
            # in-position point compares.  The burst seals first so the
            # crc names a durable state.
            self._seal_burst()
            if self.core.applied_seqno != frame.seqno():
                return
            want = int(frame.kv["crc"])
            got = self.core.state_crc()
            self.verifies += 1
            if got == want:
                self._send(encode_ack(self.core.applied_seqno))
                return
            self.diverged += 1
            from . import scrub
            if self.core.state_dir:
                scrub.enter_quarantine(
                    self.core.state_dir, reason="stream-verify",
                    seqno=frame.seqno(), epoch=frame.epoch(),
                    expect_crc=want, got_crc=got)
            self.core.quarantined = True
            self.core._fire("quar-enter")
            if self.on_diverged is not None:
                self.on_diverged(frame.seqno(), want, got)
            raise Diverged(
                f"state_crc {got:#010x} != leader's {want:#010x} at "
                f"seqno {frame.seqno()} — quarantined; snapshot re-sync "
                f"required")
        if frame.kind == "APPEND":
            gen = int(frame.kv.get("gen", 0))
            if gen != self.core.seq_gen:
                # the RESEQ announce was lost (netfault drop / attach
                # race): the record's generation stamp is the backstop
                self._seal_burst()
                self.resyncs_required += 1
                raise ResyncRequired(
                    f"APPEND seqno {frame.seqno()} carries generation "
                    f"{gen}; this follower is at {self.core.seq_gen} — "
                    f"snapshot adoption required")
            rid = frame.kv.get("rid")
            try:
                # rid scope: the apply's WAL append — and, on
                # the sync=True path, its fsync — record under the
                # originating request's id
                with trace.rid_scope(rid):
                    out = self.core.apply_replicated(
                        frame.seqno(), frame.payload, sync=False, rid=rid)
            except ReplicationGap as gap:
                self._seal_burst()
                self.gaps += 1
                self._send(encode_nack(gap.expected))
                return
            if out == "dup":
                self.dups += 1
            else:
                self.applied += 1
                self._unsynced = True
                if rid is not None:
                    self._burst_rid = rid
            self._ack_due = True
            if not defer_ack:
                self._seal_burst()
        else:  # PING carries the leader's latest seqno: gap detector
            self._seal_burst()
            if self.leader_seqno > self.core.applied_seqno:
                self.gaps += 1
                self._send(encode_nack(self.core.applied_seqno + 1))
            else:
                self._send(encode_ack(self.core.applied_seqno))


# -- leader side ------------------------------------------------------------


class _FollowerState:
    __slots__ = ("conn", "node", "acked", "next_send", "last_ack_t",
                 "attached_at", "alive", "thread", "site", "verify")

    def __init__(self, conn, node: str, next_send: int,
                 site: str = "repl", verify: bool = False):
        self.conn = conn
        self.node = node
        self.acked = 0
        self.next_send = next_send
        self.last_ack_t: float | None = None
        self.attached_at = time.monotonic()
        self.alive = True
        self.thread: threading.Thread | None = None
        self.site = site  # netfault site for APPENDs (mdelta: migration)
        self.verify = verify  # HELLO advertised verify=1


class ReplicationHub:
    """The leader's fan-out: per-follower sender threads draining the
    WAL tail, cumulative-ACK bookkeeping, and the quorum wait an insert
    blocks on before it is acknowledged to the client.

    Transport-agnostic: the daemon injects ``send(conn, data: bytes) ->
    bool`` and ``close(conn)``; the hub never touches a socket API, so
    property tests drive it with in-memory pipes.
    """

    def __init__(self, core: ServeCore, send, close,
                 hb_s: float = DEFAULT_HB_S, on_fenced=None):
        self.core = core
        self._send = send
        self._close = close
        self.hb_s = hb_s
        self.on_fenced = on_fenced
        self._cv = threading.Condition()
        self._followers: dict[int, _FollowerState] = {}
        self._stopped = False
        core.on_append = self.notify

    # -- membership --------------------------------------------------------

    def attach(self, conn, node: str, from_seqno: int,
               site: str = "repl", verify: bool = False) -> None:
        """Register one follower stream starting after ``from_seqno``
        and spawn its sender.  The caller (daemon) already decided
        stream-vs-snapshot; a sender that later finds the WAL moved past
        its position closes the connection so the follower re-HELLOs.
        ``site`` names the netfault site its APPENDs arm ("mdelta" for a
        migration delta stream).  ``verify`` marks a stream
        whose HELLO advertised VERIFY capability: its sender
        stamps anti-entropy checkpoints; the caller is responsible for
        core.enable_verify so the capture ring is live."""
        fs = _FollowerState(conn, node, from_seqno + 1, site=site,
                            verify=verify)
        fs.acked = from_seqno
        with self._cv:
            self._followers[id(conn)] = fs
            self._cv.notify_all()
        t = threading.Thread(target=self._sender, args=(fs,), daemon=True,
                             name=f"repl-send:{node}")
        fs.thread = t
        t.start()

    def detach(self, conn) -> None:
        with self._cv:
            fs = self._followers.pop(id(conn), None)
            if fs is not None:
                fs.alive = False
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            for fs in self._followers.values():
                fs.alive = False
            self._followers.clear()
            self._cv.notify_all()

    def disconnect_all(self) -> None:
        """Drop every follower stream but stay usable (a demoted leader
        cuts its followers loose so they rediscover the real one; a
        re-promotion attaches fresh streams)."""
        with self._cv:
            dropped = list(self._followers.values())
            for fs in dropped:
                fs.alive = False
            self._followers.clear()
            self._cv.notify_all()
        for fs in dropped:
            self._close(fs.conn)

    def notify(self) -> None:
        """ServeCore.on_append hook: a record landed — wake senders and
        quorum waiters.  Runs under the core lock; must never block."""
        with self._cv:
            self._cv.notify_all()

    # -- inbound (follower -> leader lines on a stream conn) ---------------

    def on_line(self, conn, text: str) -> None:
        try:
            frame = parse_frame(text)
        except ReplProtocolError:
            return  # a garbled ack is only a missed wakeup, never state
        with self._cv:
            fs = self._followers.get(id(conn))
            if fs is None:
                return
            if frame.kind == "ACK":
                fs.acked = max(fs.acked, frame.seqno())
                fs.last_ack_t = time.monotonic()
                self._cv.notify_all()
            elif frame.kind == "NACK":
                expect = int(frame.kv["expect"])
                fs.next_send = min(fs.next_send, expect)
                self._cv.notify_all()
            elif frame.kind == "FENCED":
                fenced_by = int(frame.kv.get("epoch", 0))
                fs.alive = False
                self._cv.notify_all()
                if self.on_fenced is not None:
                    self.on_fenced(fenced_by)

    # -- outbound ----------------------------------------------------------

    def _transmit(self, fs: _FollowerState, line: str, site: str) -> bool:
        """One frame through the netfault plan to one follower.  Returns
        False when the connection is gone (caller detaches)."""
        kind = netfaults.arm(site)
        if kind == "drop":
            return True  # the wire ate it; the seqno chain will notice
        if kind == "partition":
            self._close(fs.conn)
            return False
        if kind == "slow":
            time.sleep(netfaults.SLOW_S)
        data = (line + "\n").encode("ascii")
        if not self._send(fs.conn, data):
            return False
        if kind == "dup":
            self._send(fs.conn, data)
        return True

    def _sender(self, fs: _FollowerState) -> None:
        """One follower's drain loop: ship the backlog, then block on
        the append condition; PING with the latest seqno when idle so
        the follower can detect gaps and the watcher can see liveness."""
        last_sent_t = 0.0
        while fs.alive and not self._stopped:
            recs = self.core.records_from(fs.next_send - 1)
            if recs is None:
                # the WAL was sealed past this follower: it needs a
                # snapshot bootstrap, which needs a fresh HELLO
                self._close(fs.conn)
                self.detach(fs.conn)
                return
            sent_any = False
            for seqno, payload in recs:
                if not fs.alive or self._stopped:
                    return
                line = encode_append(self.core.epoch, seqno, payload,
                                     rid=self.core.rid_for(seqno),
                                     gen=self.core.seq_gen)
                if not self._transmit(fs, line, fs.site):
                    self.detach(fs.conn)
                    return
                if fs.verify:
                    # stamp the anti-entropy checkpoint right AFTER the
                    # APPEND it names: the follower compares
                    # at exactly this applied position.  verify_crc is
                    # only non-None at captured verify points, so the
                    # common record ships nothing extra.
                    vcrc = self.core.verify_crc(seqno)
                    if vcrc is not None:
                        vline = encode_verify(self.core.epoch, seqno,
                                              vcrc)
                        if not self._transmit(fs, vline, fs.site):
                            self.detach(fs.conn)
                            return
                fs.next_send = seqno + 1
                sent_any = True
            if sent_any:
                last_sent_t = time.monotonic()
                continue  # more may have landed while we were sending
            # durable_seqno, not applied: records_from withholds the
            # group-commit window's unsynced tail, so waking on applied
            # would busy-spin until the shared fsync lands — and a PING
            # advertising an unsynced seqno would NACK-loop the follower
            # asking for records the leader will not ship yet
            with self._cv:
                if fs.next_send <= self.core.durable_seqno:
                    continue  # a NACK rewound us while unlocked
                self._cv.wait(self.hb_s)
            if not fs.alive or self._stopped:
                return
            if (time.monotonic() - last_sent_t >= self.hb_s
                    and fs.next_send > self.core.durable_seqno):
                line = encode_ping(self.core.epoch,
                                   self.core.durable_seqno)
                if not self._transmit(fs, line, "hb"):
                    self.detach(fs.conn)
                    return
                last_sent_t = time.monotonic()

    def announce_reseq(self) -> int:
        """Broadcast the leader's re-sequence to every attached follower
        as one RESEQ frame (netfault site "reseq" — the chaos sweep's
        arm on the replicated swap).  Best-effort by design: a follower
        that misses the frame trips the ``gen=`` stamp on the next
        APPEND, and one that was attached to the pre-reseq WAL hits the
        sealed-WAL snapshot path on its next drain — every road leads to
        snapshot adoption.  Returns the number of followers reached."""
        line = encode_reseq(self.core.epoch, self.core.applied_seqno,
                            self.core.seq_gen, self.core.sig)
        with self._cv:
            targets = list(self._followers.values())
        reached = 0
        for fs in targets:
            if not fs.alive:
                continue
            if self._transmit(fs, line, "reseq"):
                reached += 1
            else:
                self.detach(fs.conn)
        return reached

    # -- queries -----------------------------------------------------------

    def wait_acks(self, seqno: int, need: int, timeout_s: float) -> bool:
        """Block until ``need`` followers have cumulatively acked
        ``seqno`` (their copy is durable + applied), or the deadline
        passes.  The replication quorum an insert rides on."""
        if need <= 0:
            return True
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                acked = sum(1 for fs in self._followers.values()
                            if fs.acked >= seqno)
                if acked >= need:
                    return True
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    return False
                self._cv.wait(min(left, 0.1))

    def follower_count(self) -> int:
        with self._cv:
            return len(self._followers)

    def lag_report(self) -> dict:
        """node -> {acked, lag, ack_age_s} for STATS and the status
        file; lag is in records against the leader's applied seqno."""
        now = time.monotonic()
        applied = self.core.applied_seqno
        with self._cv:
            return {
                fs.node: {
                    "acked": fs.acked,
                    "lag": max(0, applied - fs.acked),
                    "ack_age_s": (round(now - fs.last_ack_t, 3)
                                  if fs.last_ack_t is not None else None),
                }
                for fs in self._followers.values()
            }


# -- snapshot bootstrap (client side) ---------------------------------------


def recv_exact(rf, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = rf.read(n - len(out))
        if not chunk:
            raise ConnectionError(
                f"replication peer closed mid-snapshot "
                f"({len(out)}/{n} bytes)")
        out.extend(chunk)
    return bytes(out)


def parse_snapshot_header(line: str) -> dict:
    toks = line.split()
    if not toks or toks[0] != "OK":
        raise ReplProtocolError(f"snapshot fetch refused: {line!r}")
    kv = parse_kv_args(toks[1:])
    for field in ("bytes", "seqno", "epoch", "crc"):
        if field not in kv:
            raise ReplProtocolError(
                f"snapshot header missing {field}=: {line!r}")
    return kv


def fetch_snapshot(host: str, port: int, timeout_s: float = 60.0,
                   tenant: str | None = None):
    """Bootstrap fetch: ``REPL SNAPSHOT`` against a leader (for
    ``tenant``'s state dir when named).  Returns ``(blob, seqno, epoch,
    sig)`` with the crc already verified."""
    line = b"REPL SNAPSHOT\n" if tenant in (None, "default") \
        else f"REPL SNAPSHOT tenant={tenant}\n".encode("ascii")
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        rf = s.makefile("rb")
        s.sendall(line)
        line = rf.readline().decode("ascii").strip()
        kv = parse_snapshot_header(line)
        blob = recv_exact(rf, int(kv["bytes"]))
    if payload_crc(blob) != int(kv["crc"]):
        raise IntegrityError(
            "replication snapshot failed its crc32 in flight")
    return blob, int(kv["seqno"]), int(kv["epoch"]), kv.get("sig", "")


def bootstrap_state_dir(state_dir: str, host: str, port: int,
                        timeout_s: float = 60.0,
                        tenant: str | None = None) -> int:
    """First start of a follower with an EMPTY state dir: fetch the
    leader's snapshot, seal it locally (sidecar resealed — the blob was
    crc-verified in flight), lay down a fresh WAL at the leader's epoch.
    Returns the snapshot's applied seqno; the caller then enters through
    ServeCore.open — the exact restart path, same as bootstrap."""
    from ..integrity.sidecar import write_sidecar
    from .state import snap_name
    from .wal import create_wal, wal_path
    blob, seqno, epoch, sig = fetch_snapshot(host, port, timeout_s,
                                             tenant=tenant)
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, snap_name(seqno))
    tmp = path + ".fetch"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    snap = load_serve_snapshot(tmp, integrity="trust")
    snap.validate()
    if sig and snap.sig != sig:
        raise IntegrityError(
            f"replication snapshot sig {snap.sig[:12]}... does not match "
            f"the advertised {sig[:12]}...")
    os.replace(tmp, path)
    write_sidecar(path)
    create_wal(wal_path(state_dir), snap.sig, epoch=epoch)
    return seqno


# -- the follower's connection owner ----------------------------------------


class Replicator:
    """Own the follower->leader connection for one daemon: discover the
    leader, HELLO, then pump bytes into a :class:`ReplApplier` until the
    stream dies — and reconnect.  ``discover`` is injected
    (serve/cluster.py): it returns the current leader's (host, port) or
    None, so failover re-pointing is just discovery returning a new
    address."""

    def __init__(self, core: ServeCore, node_id: str, discover,
                 hb_s: float = DEFAULT_HB_S, retry_s: float = 0.2,
                 events: list | None = None, tenant: str | None = None,
                 mig: bool = False, verify: bool = True,
                 on_diverged=None):
        self.core = core
        self.node_id = node_id
        self.discover = discover
        self.tenant = tenant  # None/"default": the plain handshake bytes
        self.mig = mig        # migration delta stream (mdelta site)
        #: advertise VERIFY capability in HELLO (migration
        #: delta streams replay into a build-side core mid-cutover, so
        #: they stay on the plain handshake)
        self.verify = verify and not mig
        self.on_diverged = on_diverged
        self.hb_s = hb_s
        self.retry_s = retry_s
        self.events = events if events is not None else []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.applier: ReplApplier | None = None
        self.connected_to: tuple[str, int] | None = None
        self.last_frame_t: float | None = None
        self.resyncs = 0
        self.quarantine_heals = 0

    @property
    def lag(self) -> int:
        a = self.applier
        return a.lag if a is not None else 0

    @property
    def leader_seqno(self) -> int:
        a = self.applier
        return a.leader_seqno if a is not None else self.core.applied_seqno

    def start(self) -> "Replicator":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"replicator:{self.node_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def stream_age_s(self) -> float | None:
        """Seconds since the last frame arrived (None = never streamed)
        — the staleness signal the failover watcher deadlines."""
        t = self.last_frame_t
        return None if t is None else max(0.0, time.monotonic() - t)

    def _run(self) -> None:
        while not self._stop.is_set():
            target = self.discover()
            if target is None:
                self._stop.wait(self.retry_s)
                continue
            try:
                self._stream_once(target)
            except (OSError, ConnectionError, ReplProtocolError,
                    IntegrityError) as exc:
                self.events.append(("repl_error", str(exc)))
                self._stop.wait(self.retry_s)
            finally:
                self.connected_to = None

    def _stream_once(self, target: tuple[str, int]) -> None:
        host, port = target
        from . import scrub
        if self.core.quarantined or (
                self.core.state_dir
                and scrub.read_quarantine(self.core.state_dir)
                is not None):
            # quarantine healing takes priority over streaming: the
            # durable marker survives any kill, so every restart lands
            # back here until the re-sync completes and clears it
            self._heal_quarantine(target)
            return  # reconnect streams normally from the adopted boundary
        with socket.create_connection(
                (host, port),
                timeout=max(HANDSHAKE_S, 3 * self.hb_s)) as sock:
            rf = sock.makefile("rb")
            hello = encode_hello(self.node_id, self.core.epoch,
                                 self.core.applied_seqno, self.core.sig,
                                 tenant=self.tenant, mig=self.mig,
                                 verify=self.verify)
            sock.sendall((hello + "\n").encode("ascii"))
            line = rf.readline().decode("ascii").strip()
            toks = line.split()
            if not toks or toks[0] != "OK":
                if " badrepl " in f" {line} ":
                    # our sig is unknown to the leader's chain: we
                    # applied a re-sequence generation the cluster lost
                    # (the old leader died before its swap quorum-acked,
                    # ).  Without an exit this retries forever;
                    # with one, the orphan rolls back to the surviving
                    # leader's generation — sound, because it is in our
                    # own manifest chain and nothing acked lives only in
                    # the orphaned gen.
                    if self._adopt_across_badrepl(host, port):
                        return  # reconnect under the adopted identity
                raise ReplProtocolError(f"HELLO refused: {line!r}")
            kv = parse_kv_args(toks[1:])
            if kv.get("mode") == "snapshot":
                self.resyncs += 1
                self.events.append(("repl_resync", int(kv["seqno"])))
                blob = recv_exact(rf, int(kv["bytes"]))
                if payload_crc(blob) != int(kv["crc"]):
                    raise IntegrityError("replication snapshot failed "
                                         "its crc32 in flight")
                tmp = os.path.join(self.core.state_dir, "resync.fetch")
                with open(tmp, "wb") as f:
                    f.write(blob)
                try:
                    snap = load_serve_snapshot(tmp, integrity="trust")
                    if (snap.sig != self.core.sig
                            and snap.seq_gen > self.core.seq_gen):
                        # the leader re-sequenced: adopt the
                        # new generation as one unit, sanctioned by a
                        # durable adopt manifest FIRST so a kill inside
                        # reset_from_snapshot (old WAL beside a new-sig
                        # snapshot) heals on restart instead of refusing
                        from . import reseq as reseq_mod
                        reseq_mod.write_adoption(
                            self.core.state_dir, self.core.sig,
                            self.core.seq_gen, snap.sig, snap.seq_gen)
                        self.core.reset_from_snapshot(
                            snap, allow_sig_change=True)
                        reseq_mod.finish_adoption(
                            self.core.state_dir, snap.sig, snap.seq_gen)
                        self.events.append(("repl_reseq_adopt",
                                            snap.seq_gen))
                    else:
                        self.core.reset_from_snapshot(snap)
                finally:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
            elif kv.get("mode") != "stream":
                raise ReplProtocolError(f"unknown HELLO mode: {line!r}")
            self.connected_to = target
            self.events.append(("repl_connected", f"{host}:{port}"))

            def send_up(text: str) -> None:
                sock.sendall((text + "\n").encode("ascii"))

            applier = ReplApplier(self.core, send_up,
                                  on_diverged=self.on_diverged)
            self.applier = applier
            sock.settimeout(max(0.2, 3 * self.hb_s))
            while not self._stop.is_set():
                try:
                    data = sock.recv(1 << 16)
                except socket.timeout:
                    continue  # staleness is the watcher's deadline call
                if not data:
                    return  # leader went away: rediscover + reconnect
                applier.feed(data)
                self.last_frame_t = time.monotonic()

    def _heal_quarantine(self, target: tuple[str, int]) -> None:
        """The quarantine re-sync: this replica's state
        proved divergent, so stream resumption is forbidden — fetch the
        leader's snapshot and adopt it WHOLE, rolling back any divergent
        tail (the leader re-streams every acked record past the
        snapshot boundary on reconnect).  Phase machine, each phase
        durable in the quarantine marker BEFORE its work starts::

            diverged -> resync -> verify -> (cleared)

        kill -9 anywhere re-enters here on restart (the marker survives;
        reads stay refused throughout) and every step is idempotent — a
        re-fetch is just a fresh snapshot.  The ``quar-resync`` /
        ``quar-verify`` / ``quar-clear`` serve-fault sites make each
        boundary deterministically killable."""
        from . import scrub
        core = self.core
        host, port = target
        core.quarantined = True  # restart path: marker seen before flag
        scrub.mark_phase(core.state_dir, scrub.PHASE_RESYNC)
        core._fire("quar-resync")
        blob, seqno, epoch, sig = fetch_snapshot(
            host, port, timeout_s=max(5.0, 10 * self.hb_s),
            tenant=self.tenant)
        tmp = os.path.join(core.state_dir, "resync.fetch")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        try:
            snap = load_serve_snapshot(tmp, integrity="trust")
            if snap.sig != core.sig and snap.seq_gen > core.seq_gen:
                # the leader ALSO re-sequenced while we were dark:
                # sanction the generation adoption exactly like the
                # ordinary snapshot-mode path
                from . import reseq as reseq_mod
                reseq_mod.write_adoption(
                    core.state_dir, core.sig, core.seq_gen,
                    snap.sig, snap.seq_gen)
                core.reset_from_snapshot(snap, allow_sig_change=True,
                                         allow_rollback=True)
                reseq_mod.finish_adoption(core.state_dir, snap.sig,
                                          snap.seq_gen)
            else:
                core.reset_from_snapshot(snap, allow_rollback=True)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        # the adopted state IS the leader's sealed snapshot (crc-checked
        # in flight, resealed locally): record the crc we rejoined at —
        # the next in-stream VERIFY point is the live rejoin proof
        scrub.mark_phase(core.state_dir, scrub.PHASE_VERIFY,
                         crc=core.state_crc(), seqno=core.applied_seqno)
        core._fire("quar-verify")
        scrub.clear_quarantine(core.state_dir)
        core.quarantined = False
        core._fire("quar-clear")
        self.resyncs += 1
        self.quarantine_heals += 1
        self.events.append(("quarantine_healed", core.applied_seqno,
                            core.state_crc()))

    def _adopt_across_badrepl(self, host: str, port: int) -> bool:
        """The snapshot-adoption exit for a ``badrepl`` refusal: this
        replica serves a sequence generation the surviving leader's
        chain has never seen (it applied a RESEQ swap whose leader died
        before the quorum ack, the re-sequence's orphan).  Fetch the leader's
        snapshot and, ONLY when its sig is in our own manifest chain
        (i.e. we are rolling back along our own history, not adopting a
        foreign build input), adopt it under a durable adoption manifest
        — the exact discipline of the forward gen-mismatch path, with
        the rollback sanctioned the same way.  Returns True when the
        core now serves the leader's generation."""
        from . import reseq as reseq_mod
        core = self.core
        if not core.state_dir:
            return False
        try:
            blob, seqno, epoch, sig = fetch_snapshot(
                host, port, timeout_s=max(5.0, 10 * self.hb_s),
                tenant=self.tenant)
        except (OSError, ConnectionError, ReplProtocolError,
                IntegrityError) as exc:
            self.events.append(("repl_error", f"badrepl fetch: {exc}"))
            return False
        if not sig or sig == core.sig:
            return False
        if not reseq_mod.chain_has_sig(core.state_dir, sig):
            # genuinely a different build input: keep refusing loudly
            self.events.append(("repl_error",
                                f"badrepl sig {sig[:12]}... not in the "
                                f"local chain — not adopting"))
            return False
        tmp = os.path.join(core.state_dir, "resync.fetch")
        with open(tmp, "wb") as f:
            f.write(blob)
        try:
            snap = load_serve_snapshot(tmp, integrity="trust")
            if snap.sig != sig:
                raise IntegrityError(
                    f"replication snapshot sig {snap.sig[:12]}... does "
                    f"not match the advertised {sig[:12]}...")
            reseq_mod.write_adoption(core.state_dir, core.sig,
                                     core.seq_gen, snap.sig, snap.seq_gen)
            core.reset_from_snapshot(snap, allow_sig_change=True,
                                     allow_gen_rollback=True)
            reseq_mod.finish_adoption(core.state_dir, snap.sig,
                                      snap.seq_gen)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self.resyncs += 1
        self.events.append(("repl_reseq_rollback", snap.seq_gen))
        return True
