"""Remote build workers: distext legs over the fleet wire.

The distributed out-of-core build is single-host — its "legs" are
subprocesses sharing one filesystem with the supervisor.  This module is
the multi-host arm: a ``sheep worker`` daemon with its OWN state dir and
no shared filesystem accepts ``LEG`` jobs over the same line-protocol
family the serve tier speaks, runs the existing ``hist``/``distmap`` leg
code (ops/extmem, ops/distext) under its own ``SHEEP_MEM_BUDGET``, and
streams the sealed artifact back — crc-checked end to end, so a remote
artifact can never be admitted torn.

Wire shape (one connection per leg job, the replication snapshot-transfer
discipline: kv header naming byte counts + crcs, then exactly that many
raw bytes — serve/replicate.fetch_snapshot):

  supervisor -> worker
    LEG key=K kind=hist|distmap start=A end=B beat=S
        bytes=N crc=C seqbytes=M seqcrc=C2\\n
    <N raw .dat record-slice bytes> <M raw sequence-file bytes>

  worker -> supervisor (same connection)
    BEAT key=K\\n                     every ``beat`` seconds while the leg
                                     runs — the WIRE heartbeat; the
                                     supervisor touches the attempt's
                                     local .hb file on receipt, so the
                                     existing mtime staleness machinery
                                     (``stale_after_polls`` included)
                                     carries over verbatim
    OK key=K sumbytes=S sumcrc=CS bytes=N crc=C perfbytes=P perfcrc=CP\\n
    <S sidecar bytes> <N artifact bytes> <P perf-report bytes>

The sidecar travels FIRST (the sheep_mv_artifact ordering): a receiver
that verified the artifact crc also holds its matching checksum, and the
supervisor still fscks the fetched temp before the atomic publish — the
wire adds a transfer-integrity layer, it never replaces the admission
gate.

Identity: the worker receives records ``[A, B)`` of the original file as
a standalone slice, streams it locally as ``[0, B-A)``, and labels the
artifact with the TRUE range — per-range histograms are pure functions
of the records (write_histogram(start, end) is a label, not an offset
into the local file), and a partial forest over the shared sequence
depends only on the records and the sequence, so the returned artifact
is byte-identical to the one a shared-filesystem leg writes.  Shipping
the slice costs one wire crossing; the planner prices that against the
local-disk dispatch (plan/model.plan_transport).

Fault surface: ``SHEEP_SERVE_NETFAULT_PLAN`` gains the worker-wire sites
``wleg`` (the supervisor's LEG send), ``wbeat`` (a worker BEAT), and
``wart`` (the worker's artifact return) — drop/partition/slow/dup at
each, executed by the sender exactly like ReplicationHub._transmit.
``METRICS`` answers the standard scrape (``sheep_worker_*`` + process
gauges) so ``sheep top`` sees build workers next to serve tenants.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import zlib

from .netfaults import SLOW_S, arm
from .protocol import MAX_LINE, BadRequest, err_line, parse_kv_args
from .replicate import recv_exact

#: comma list of remote build workers ("host:port[,host:port...]") the
#: distext supervisor may ship legs to
WORKER_ADDRS_ENV = "SHEEP_WORKER_ADDRS"
#: wire heartbeat interval for remote legs (BEAT frames)
WORKER_BEAT_ENV = "SHEEP_WORKER_BEAT_S"

#: address discovery for scripts (the serve.addr idiom): "host port\n"
#: in the worker's state dir, rewritten on every start
WORKER_ADDR_FILE = "worker.addr"

DEFAULT_BEAT_S = 1.0

#: chunk size for streaming slice/artifact bytes over the wire — the
#: supervisor and worker both stay O(chunk), never O(slice)
WIRE_CHUNK = 1 << 20


def payload_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def parse_worker_addrs(spec: str) -> list:
    """``host:port[,host:port...]`` -> [(host, port), ...] (the
    SHEEP_WORKER_ADDRS grammar; blanks skipped)."""
    out = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, sep, port = entry.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"{WORKER_ADDRS_ENV} entry {entry!r}: want host:port")
        out.append((host, int(port)))
    return out


def file_crc(path: str, offset: int = 0, length: int | None = None) -> int:
    """Streaming crc32 of ``length`` bytes of ``path`` from ``offset``
    (None = to EOF) — the pre-pass that lets a sender put the crc in the
    header without holding the payload."""
    crc = 0
    remaining = length
    with open(path, "rb") as f:
        f.seek(offset)
        while remaining is None or remaining > 0:
            want = WIRE_CHUNK if remaining is None \
                else min(WIRE_CHUNK, remaining)
            chunk = f.read(want)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            if remaining is not None:
                remaining -= len(chunk)
    if remaining:
        raise ConnectionError(
            f"{path}: short read ({remaining} byte(s) missing at "
            f"offset {offset})")
    return crc & 0xFFFFFFFF


def send_file(sock: socket.socket, path: str, offset: int = 0,
              length: int | None = None) -> int:
    """Stream ``length`` bytes of ``path`` from ``offset`` down the
    socket in O(chunk) memory; returns bytes sent."""
    sent = 0
    remaining = length
    with open(path, "rb") as f:
        f.seek(offset)
        while remaining is None or remaining > 0:
            want = WIRE_CHUNK if remaining is None \
                else min(WIRE_CHUNK, remaining)
            chunk = f.read(want)
            if not chunk:
                break
            sock.sendall(chunk)
            sent += len(chunk)
            if remaining is not None:
                remaining -= len(chunk)
    return sent


def parse_leg_header(line: str) -> dict:
    """The LEG request line -> validated job dict.  Raises BadRequest on
    anything malformed — a worker must refuse garbage before it reads a
    single payload byte (the byte counts come from this line)."""
    toks = line.split()
    if not toks or toks[0] != "LEG":
        raise BadRequest(f"expected LEG, got {line!r}")
    kv = parse_kv_args(toks[1:])
    for field in ("key", "kind", "start", "end", "bytes", "crc"):
        if field not in kv:
            raise BadRequest(f"LEG missing {field}=")
    if kv["kind"] not in ("hist", "distmap"):
        raise BadRequest(f"LEG kind {kv['kind']!r} must be hist|distmap")
    try:
        job = {
            "key": kv["key"],
            "kind": kv["kind"],
            "start": int(kv["start"]),
            "end": int(kv["end"]),
            "bytes": int(kv["bytes"]),
            "crc": int(kv["crc"]),
            "seqbytes": int(kv.get("seqbytes", "0")),
            "seqcrc": int(kv.get("seqcrc", "0")),
            "beat": float(kv.get("beat", str(DEFAULT_BEAT_S))),
        }
    except ValueError as exc:
        raise BadRequest(f"LEG bad numeric field: {exc}")
    if job["start"] < 0 or job["end"] < job["start"]:
        raise BadRequest(f"LEG bad range [{job['start']}:{job['end']})")
    if job["bytes"] != (job["end"] - job["start"]) * 12:
        raise BadRequest(
            f"LEG bytes={job['bytes']} != 12 x {job['end'] - job['start']} "
            f"records")
    if job["kind"] == "distmap" and job["seqbytes"] <= 0:
        raise BadRequest("LEG distmap needs seqbytes= (the shared "
                         "sequence every leg builds over)")
    return job


def parse_result_header(line: str) -> dict:
    """The worker's OK line -> field dict (ConnectionError on ERR/garbage
    so the supervisor's typed retry path fires)."""
    toks = line.split()
    if not toks or toks[0] != "OK":
        raise ConnectionError(f"worker refused leg: {line.strip()!r}")
    kv = parse_kv_args(toks[1:])
    for field in ("key", "sumbytes", "sumcrc", "bytes", "crc"):
        if field not in kv:
            raise ConnectionError(f"worker result missing {field}=: "
                                  f"{line.strip()!r}")
    return {"key": kv["key"], "sumbytes": int(kv["sumbytes"]),
            "sumcrc": int(kv["sumcrc"]), "bytes": int(kv["bytes"]),
            "crc": int(kv["crc"]), "perfbytes": int(kv.get("perfbytes",
                                                           "0")),
            "perfcrc": int(kv.get("perfcrc", "0"))}


class _WireBeater:
    """Daemon thread sending ``BEAT key=K`` frames every ``interval_s``
    until stopped — the wire twin of supervisor/heartbeat.HeartbeatWriter.
    Each send is a ``wbeat`` netfault site; a ``partition`` there closes
    the connection (the leg keeps running, the supervisor sees the link
    die).  Send errors stop the beater silently: the final artifact send
    will surface the broken link as a typed failure."""

    def __init__(self, sock: socket.socket, wlock: threading.Lock,
                 key: str, interval_s: float):
        self._sock = sock
        self._wlock = wlock
        self._key = key
        self.interval_s = max(0.01, interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.partitioned = False

    def start(self) -> "_WireBeater":
        self._send()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"wire-beat:{self._key}")
        self._thread.start()
        return self

    def _send(self) -> None:
        fault = arm("wbeat")
        if fault == "drop":
            return
        if fault == "partition":
            self.partitioned = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._stop.set()
            return
        if fault == "slow":
            time.sleep(SLOW_S)
        frame = f"BEAT key={self._key}\n".encode("ascii")
        with self._wlock:
            self._sock.sendall(frame)
            if fault == "dup":
                self._sock.sendall(frame)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._send()
            except OSError:
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)


class WorkerDaemon:
    """One remote build worker: accept loop + thread-per-leg execution.

    Shares NOTHING with the supervisor but the wire: slices land in (and
    artifacts are read back from) ``state_dir``, budgets come from this
    process's own environment (``SHEEP_MEM_BUDGET`` — the whole point of
    shipping a leg is that it folds under the worker's budget, not the
    supervisor's)."""

    def __init__(self, state_dir: str, host: str = "127.0.0.1",
                 port: int = 0, beat_s: float | None = None,
                 integrity: str | None = None):
        self.state_dir = state_dir
        self.host = host
        self.port = port
        env_beat = os.environ.get(WORKER_BEAT_ENV, "")
        self.beat_s = beat_s if beat_s is not None \
            else float(env_beat or DEFAULT_BEAT_S)
        self.integrity = integrity
        self.started_at = time.monotonic()  # uptime-gauge origin
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        from ..obs.metrics import Registry
        self.registry = Registry()
        self._inflight = self.registry.gauge(
            "sheep_worker_legs_inflight",
            "build legs currently executing on this worker")
        self._done = self.registry.counter(
            "sheep_worker_legs_done",
            "build legs completed (artifact streamed back)")
        self._shipped = self.registry.counter(
            "sheep_worker_bytes_shipped",
            "payload bytes over the leg wire, both directions")

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> tuple:
        assert self._listener is not None, "worker not started"
        return self._listener.getsockname()[:2]

    def start(self) -> "WorkerDaemon":
        os.makedirs(self.state_dir, exist_ok=True)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        host, port = self.address
        with open(os.path.join(self.state_dir, WORKER_ADDR_FILE),
                  "w") as f:
            f.write(f"{host} {port}\n")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="worker-accept")
        self._accept_thread.start()
        return self

    def run_forever(self) -> None:
        while not self._stop.wait(0.5):
            pass

    def shutdown(self) -> None:
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="worker-conn").start()

    # -- one connection ----------------------------------------------------

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(None)
            rf = conn.makefile("rb")
            raw = rf.readline(MAX_LINE)
            if not raw:
                return
            line = raw.decode("utf-8", "replace").strip()
            verb = line.split(None, 1)[0] if line else ""
            if verb == "PING":
                conn.sendall(b"OK pong\n")
            elif verb == "METRICS":
                body = self._metrics_body().encode("utf-8")
                conn.sendall(f"OK bytes={len(body)}\n".encode("ascii"))
                conn.sendall(body)
            elif verb == "QUIT":
                conn.sendall(b"OK bye\n")
                self._stop.set()
            elif verb == "LEG":
                self._serve_leg(conn, rf, line)
            else:
                conn.sendall(
                    (err_line("badreq", f"unknown verb {verb!r}") + "\n")
                    .encode("utf-8"))
        except (OSError, ValueError):
            pass  # a dead peer mid-anything: nothing to answer
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _metrics_body(self) -> str:
        from ..obs.metrics import set_process_gauges
        set_process_gauges(self.registry, self.started_at)
        return self.registry.render()

    def _serve_leg(self, conn: socket.socket, rf, line: str) -> None:
        try:
            job = parse_leg_header(line)
        except BadRequest as exc:
            conn.sendall((err_line("badreq", str(exc)) + "\n")
                         .encode("utf-8"))
            return
        # receive + crc-verify the payloads BEFORE any disk write: a
        # torn or corrupted slice is a refusal, never a wrong artifact
        slice_bytes = recv_exact(rf, job["bytes"])
        seq_bytes = recv_exact(rf, job["seqbytes"]) if job["seqbytes"] \
            else b""
        if payload_crc(slice_bytes) != job["crc"]:
            conn.sendall((err_line("badleg", "slice crc mismatch") + "\n")
                         .encode("utf-8"))
            return
        if seq_bytes and payload_crc(seq_bytes) != job["seqcrc"]:
            conn.sendall((err_line("badleg", "sequence crc mismatch")
                          + "\n").encode("utf-8"))
            return

        self._inflight.inc(1)
        self._shipped.inc(len(slice_bytes) + len(seq_bytes))
        wlock = threading.Lock()
        beater = _WireBeater(conn, wlock, job["key"], job["beat"])
        try:
            beater.start()
            out, perf = self._run_leg(job, slice_bytes, seq_bytes)
            beater.stop()
            if beater.partitioned:
                return  # the link was netfault-killed; nothing to send
            self._send_result(conn, wlock, job["key"], out, perf)
            self._done.inc(1)
        except Exception as exc:  # noqa: BLE001 — becomes a typed wire err
            beater.stop()
            try:
                with wlock:
                    conn.sendall(
                        (err_line("legfail",
                                  f"{type(exc).__name__}: {exc}") + "\n")
                        .encode("utf-8"))
            except OSError:
                pass
        finally:
            self._inflight.inc(-1)

    # -- leg execution -----------------------------------------------------

    def _run_leg(self, job: dict, slice_bytes: bytes,
                 seq_bytes: bytes) -> tuple:
        """Run one hist/distmap leg over the LOCAL slice and return
        (artifact path, perf dict).  The slice holds records [start, end)
        of the original file at local offsets [0, end-start); artifacts
        are labeled with the TRUE range, so they are byte-identical to a
        shared-filesystem leg's (module docstring)."""
        from ..integrity.sidecar import checksummed_write
        key, kind = job["key"], job["kind"]
        a, b = job["start"], job["end"]
        local = os.path.join(self.state_dir, f"{key}.slice.dat")
        with checksummed_write(local, "wb",
                               expect_bytes=len(slice_bytes)) as f:
            f.write(slice_bytes)
        perf: dict = {}
        if kind == "hist":
            from ..ops.distext import write_histogram
            from ..ops.extmem import range_degree_histogram
            out = os.path.join(self.state_dir, f"{key}.hist")
            deg, max_vid, records = range_degree_histogram(
                local, start_edge=0, end_edge=b - a, perf=perf)
            write_histogram(out, deg, records, max_vid, a, b)
            return out, perf
        from ..cli.graph2tree import _tree_sig
        from ..io.seqfile import read_sequence
        from ..io.trefile import write_tree
        from ..ops.extmem import build_forest_extmem
        seq_path = os.path.join(self.state_dir, f"{key}.seq")
        with checksummed_write(seq_path, "wb",
                               expect_bytes=len(seq_bytes)) as f:
            f.write(seq_bytes)
        out = os.path.join(self.state_dir, f"{key}.tre")
        seq = read_sequence(seq_path)
        ck = os.path.join(self.state_dir, f"ck-{key}")
        seq, forest = build_forest_extmem(
            local, seq=seq, start_edge=0, end_edge=b - a,
            checkpoint_dir=ck, resume=True, integrity=self.integrity,
            perf=perf)
        write_tree(out, forest.parent, forest.pst_weight,
                   sig=_tree_sig(seq))
        return out, perf

    def _send_result(self, conn: socket.socket, wlock: threading.Lock,
                     key: str, out: str, perf: dict) -> None:
        """Stream the sealed artifact home, sidecar-first, each span
        crc'd in the header.  ``wart`` is the netfault site: a
        ``partition`` here closes the link mid-payload — the torn-return
        shape the supervisor's crc gate must catch."""
        import json

        from ..obs.metrics import proc_status
        with open(out + ".sum", "rb") as f:
            sum_bytes = f.read()
        art_len = os.path.getsize(out)
        art_crc = file_crc(out)
        perf_bytes = json.dumps(
            {"range": None, "perf": perf, "proc_status": proc_status()},
            sort_keys=True).encode("utf-8")
        head = (f"OK key={key} sumbytes={len(sum_bytes)} "
                f"sumcrc={payload_crc(sum_bytes)} bytes={art_len} "
                f"crc={art_crc} perfbytes={len(perf_bytes)} "
                f"perfcrc={payload_crc(perf_bytes)}\n").encode("ascii")
        fault = arm("wart")
        with wlock:
            if fault == "drop":
                return  # never sent; the supervisor's staleness redispatches
            if fault == "slow":
                time.sleep(SLOW_S)
            if fault == "partition":
                # close mid-artifact: a torn return, never admitted
                conn.sendall(head)
                conn.sendall(sum_bytes)
                send_file(conn, out, length=art_len // 2)
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return
            reps = 2 if fault == "dup" else 1
            for _ in range(reps):
                conn.sendall(head)
                conn.sendall(sum_bytes)
                sent = send_file(conn, out)
                conn.sendall(perf_bytes)
                self._shipped.inc(len(sum_bytes) + sent + len(perf_bytes))


def read_worker_addr(state_dir: str) -> tuple:
    """The worker's published (host, port) — the serve.addr idiom."""
    with open(os.path.join(state_dir, WORKER_ADDR_FILE)) as f:
        host, port = f.read().split()
    return host, int(port)


__all__ = [
    "DEFAULT_BEAT_S",
    "WORKER_ADDRS_ENV",
    "WORKER_ADDR_FILE",
    "WORKER_BEAT_ENV",
    "WorkerDaemon",
    "file_crc",
    "parse_leg_header",
    "parse_result_header",
    "parse_worker_addrs",
    "payload_crc",
    "read_worker_addr",
    "send_file",
]
