"""The distext supervisor's remote dispatch arm.

:class:`RemoteRunner` is a drop-in runner (the ``start(argv, hb_path,
log_path) -> handle`` seam of supervisor/supervise.py): ``distext``
hist/map legs ship over the wire to ``sheep worker`` daemons
(serve/worker.py), everything else — merge legs, the sort — falls
through to the local base runner.  Because the remote attempt is just
another handle, the supervisor's recovery machinery cannot fork: retry/
backoff, staleness, speculation, sig arbitration, and the fsck-gated
publish all apply to remote legs verbatim.

The three bridges that make that true:

  heartbeats   the worker's ``BEAT`` frames touch the attempt's LOCAL
               ``.hb`` file (supervisor/heartbeat.beat) on receipt — the
               mtime the supervisor already polls, so wall-clock
               deadlines AND ``stale_after_polls`` counting carry over
               unchanged.  A silent worker looks exactly like a silent
               subprocess.
  exit status  connection loss, a refused leg, and a crc-mismatched
               return all surface as a nonzero ``poll()`` with the
               typed reason appended to the attempt's log — the same
               "exit status != 0" path a crashed subprocess takes,
               feeding the same per-leg retry/backoff budget.
  admission    the fetched sidecar lands at ``tmp + ".sum"`` first, the
               artifact's bytes at a private ``.fetch`` name, renamed to
               ``tmp`` only after the wire crc verified END-TO-END — so
               a torn transfer never exists at the temp name and the
               supervisor's fsck gate (_validate_artifact) remains the
               single admission decision for local and remote artifacts
               alike.

Worker selection rotates round-robin and skips addresses that recently
failed at the CONNECTION level (a refused connect or a mid-stream link
loss marks the address dead for ``dead_cooldown_s``); a leg-level
failure (ERR legfail) does not — the worker is alive and answering, the
leg is the problem.  Each dispatch records worker/attempt/speculation
provenance in ``wire-<artifact>.json`` beside the manifest, which is
what ``sheep supervise --status`` renders for remote legs.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time

from ..runtime.retry import RetryPolicy

#: attempt-temp suffix (supervise._launch: "<output>.aN")
_ATTEMPT_RE = re.compile(r"^(?P<final>.+)\.a(?P<n>\d+)$")


def wire_status_path(state_dir: str, final_output: str) -> str:
    """Where a leg's remote-dispatch provenance lands (one JSON per leg,
    keyed by the artifact's basename — status.py joins on the same)."""
    return os.path.join(state_dir,
                        f"wire-{os.path.basename(final_output)}.json")


def _parse_distext_argv(argv: list) -> dict | None:
    """Recover the leg spec from the supervisor's argv (_leg_argv) —
    None when this argv is not a shippable distext leg."""
    if not argv or argv[0] != "distext" or len(argv) < 3 \
            or argv[1] not in ("hist", "map"):
        return None
    spec = {"kind": "hist" if argv[1] == "hist" else "distmap",
            "graph": argv[2], "seq": None, "out": None, "perf": None}
    i = 3
    while i < len(argv):
        tok = argv[i]
        if tok == "-r" and i + 1 < len(argv):
            a, b = argv[i + 1].split(":", 1)
            spec["start"], spec["end"] = int(a), int(b)
            i += 2
        elif tok == "-s" and i + 1 < len(argv):
            spec["seq"] = argv[i + 1]
            i += 2
        elif tok == "-o" and i + 1 < len(argv):
            spec["out"] = argv[i + 1]
            i += 2
        elif tok in ("--checkpoint-dir", "--perf-out") and i + 1 < len(argv):
            if tok == "--perf-out":
                spec["perf"] = argv[i + 1]
            i += 2
        else:
            i += 1
    if spec.get("out") is None or "start" not in spec:
        return None
    m = _ATTEMPT_RE.match(spec["out"])
    if m is None:
        return None
    spec["final"] = m.group("final")
    spec["attempt"] = int(m.group("n"))
    spec["key"] = os.path.basename(spec["final"])
    return spec


class _RemoteHandle:
    """One remote attempt: a session thread that ships the leg, relays
    BEATs into the local heartbeat file, and lands the returned artifact
    at the attempt temp — crc-gated.  ``poll()``/``cancel()`` are the
    whole contract the supervisor sees."""

    remote = True

    def __init__(self, runner: "RemoteRunner", spec: dict, addr: tuple,
                 hb_path: str, log_path: str):
        self._runner = runner
        self._spec = spec
        self._hb = hb_path
        self._log = log_path
        self._rc: int | None = None
        self._lock = threading.Lock()
        self._socks: list = []
        self.cancelled = False
        self.worker = f"{addr[0]}:{addr[1]}"
        self._threads = [threading.Thread(
            target=self._session, args=(addr, False), daemon=True,
            name=f"remote:{spec['key']}.a{spec['attempt']}")]
        self._threads[0].start()

    # -- the runner contract ----------------------------------------------

    def poll(self) -> int | None:
        return self._rc

    def cancel(self) -> None:
        self.cancelled = True
        with self._lock:
            socks = list(self._socks)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    # -- internals ---------------------------------------------------------

    def _note(self, msg: str) -> None:
        try:
            with open(self._log, "a") as f:
                f.write(msg.rstrip() + "\n")
        except OSError:
            pass

    def _finish(self, rc: int, msg: str | None = None) -> bool:
        """First finisher wins (the netfault ``dup`` path runs two
        sessions for one attempt); returns whether THIS call won."""
        with self._lock:
            if self._rc is not None:
                return False
            if msg:
                self._note(msg)
            self._rc = rc
        self._runner.attempt_done(self._spec["final"])
        return True

    def _connect(self, addr: tuple):
        """Typed retry/backoff on connection loss — a worker mid-restart
        is latency, a dead one a failed attempt (and a dead-marked
        address the rotation skips)."""
        policy: RetryPolicy = self._runner.policy
        last: Exception | None = None
        for attempt in range(policy.max_retries + 1):
            if self.cancelled:
                raise ConnectionError("attempt cancelled")
            try:
                sock = socket.create_connection(
                    addr, timeout=self._runner.connect_timeout_s)
                sock.settimeout(None)
                with self._lock:
                    self._socks.append(sock)
                return sock
            except OSError as exc:
                last = exc
                time.sleep(policy.backoff(attempt))
        raise ConnectionError(
            f"worker {addr[0]}:{addr[1]} unreachable after "
            f"{policy.max_retries + 1} connect attempt(s): {last}")

    def _session(self, addr: tuple, is_dup_twin: bool) -> None:
        from ..serve.netfaults import SLOW_S, arm
        spec = self._spec
        try:
            sock = self._connect(addr)
        except ConnectionError as exc:
            self._runner.mark_dead(addr)
            self._finish(1, f"remote: {exc}")
            return
        try:
            fault = None if is_dup_twin else arm("wleg")
            if fault == "partition":
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self._finish(1, "remote: netfault partition@wleg (link "
                                "died before dispatch)")
                return
            if fault == "dup":
                # duplicate delivery: the same leg lands on a second
                # worker too; first finisher wins, the loser is discarded
                twin_addr = self._runner.next_addr()
                t = threading.Thread(target=self._session,
                                     args=(twin_addr, True), daemon=True,
                                     name="remote-dup-twin")
                self._threads.append(t)
                t.start()
            if fault == "slow":
                time.sleep(SLOW_S)
            if fault != "drop":
                self._ship(sock, spec)
            else:
                self._note("remote: netfault drop@wleg (LEG frame never "
                           "sent; staleness will redispatch)")
            self._receive(sock, spec)
        except (OSError, ValueError) as exc:
            if not self.cancelled:
                self._runner.mark_dead(addr)
            self._finish(1, f"remote: wire lost ({type(exc).__name__}: "
                            f"{exc})")
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _ship(self, sock, spec: dict) -> None:
        from ..serve.worker import file_crc, send_file
        a, b = spec["start"], spec["end"]
        nbytes = (b - a) * 12
        crc = file_crc(spec["graph"], offset=a * 12, length=nbytes)
        seq_len = seq_crc = 0
        if spec["kind"] == "distmap":
            seq_len = os.path.getsize(spec["seq"])
            seq_crc = file_crc(spec["seq"])
        head = (f"LEG key={spec['key']} kind={spec['kind']} start={a} "
                f"end={b} beat={self._runner.beat_s} bytes={nbytes} "
                f"crc={crc} seqbytes={seq_len} seqcrc={seq_crc}\n")
        sock.sendall(head.encode("ascii"))
        send_file(sock, spec["graph"], offset=a * 12, length=nbytes)
        if seq_len:
            send_file(sock, spec["seq"])

    def _receive(self, sock, spec: dict) -> None:
        from ..serve.protocol import MAX_LINE
        from ..serve.replicate import recv_exact
        from ..serve.worker import parse_result_header, payload_crc
        from .heartbeat import beat
        rf = sock.makefile("rb")
        while True:
            raw = rf.readline(MAX_LINE)
            if not raw:
                raise ConnectionError("worker closed the link mid-leg")
            line = raw.decode("utf-8", "replace").strip()
            if line.startswith("BEAT"):
                try:
                    beat(self._hb)
                except OSError:
                    pass
                continue
            head = parse_result_header(line)  # ConnectionError on ERR
            sum_bytes = recv_exact(rf, head["sumbytes"])
            art_bytes = recv_exact(rf, head["bytes"])
            perf_bytes = recv_exact(rf, head["perfbytes"]) \
                if head["perfbytes"] else b""
            if payload_crc(sum_bytes) != head["sumcrc"] \
                    or payload_crc(art_bytes) != head["crc"] \
                    or (perf_bytes
                        and payload_crc(perf_bytes) != head["perfcrc"]):
                raise ConnectionError(
                    "artifact return failed its crc — torn or corrupted "
                    "on the wire, refused")
            self._land(spec, sum_bytes, art_bytes, perf_bytes)
            return

    def _land(self, spec: dict, sum_bytes: bytes, art_bytes: bytes,
              perf_bytes: bytes) -> None:
        """Publish the VERIFIED return to the attempt temp, sidecar
        first; the winner gate keeps a dup twin from racing the write."""
        with self._lock:
            if self._rc is not None:
                return  # a twin already finished; this copy is discarded
            tmp = spec["out"]
            with open(tmp + ".sum", "wb") as f:
                f.write(sum_bytes)
            fetch = tmp + ".fetch"
            with open(fetch, "wb") as f:
                f.write(art_bytes)
            os.replace(fetch, tmp)
            if perf_bytes and spec.get("perf"):
                from ..io.atomic import atomic_write
                try:
                    report = json.loads(perf_bytes.decode("utf-8"))
                    report["range"] = [spec["start"], spec["end"]]
                    report["verb"] = ("hist" if spec["kind"] == "hist"
                                      else "map")
                    report["worker"] = self.worker
                    with atomic_write(spec["perf"], "w") as f:
                        json.dump(report, f, indent=1, sort_keys=True)
                        f.write("\n")
                except (ValueError, OSError):
                    pass  # the perf report is best-effort telemetry
            self._rc = 0
        self._runner.attempt_done(spec["final"])


class RemoteRunner:
    """Route distext hist/map legs to remote workers; delegate the rest.

    ``addrs``: the worker fleet ((host, port) list, SHEEP_WORKER_ADDRS).
    ``base``: the local runner for non-shippable legs (merge legs read
    supervisor-local artifacts; default SubprocessRunner).
    """

    remote = True

    def __init__(self, addrs: list, base=None, beat_s: float = 1.0,
                 connect_timeout_s: float = 5.0, max_retries: int = 2,
                 backoff_base_s: float = 0.05,
                 dead_cooldown_s: float = 30.0):
        if not addrs:
            raise ValueError("RemoteRunner needs at least one worker "
                             "address (SHEEP_WORKER_ADDRS)")
        self.addrs = [tuple(a) for a in addrs]
        if base is None:
            from .supervise import SubprocessRunner
            base = SubprocessRunner()
        self.base = base
        self.beat_s = beat_s
        self.connect_timeout_s = connect_timeout_s
        self.policy = RetryPolicy(max_retries=max_retries,
                                  backoff_base_s=backoff_base_s)
        self.dead_cooldown_s = dead_cooldown_s
        self._slot = 0
        self._dead: dict = {}
        self._lock = threading.Lock()
        #: per-leg dispatch bookkeeping for wire-<leg>.json
        self._dispatches: dict = {}
        self._speculations: dict = {}
        self._live: dict = {}

    # -- worker selection --------------------------------------------------

    def mark_dead(self, addr: tuple) -> None:
        with self._lock:
            self._dead[tuple(addr)] = time.monotonic()

    def next_addr(self) -> tuple:
        """Round-robin over the fleet, skipping addresses inside their
        dead cooldown — unless every address is dead, in which case the
        least-recently-failed one gets the probe (someone must)."""
        with self._lock:
            now = time.monotonic()
            for _ in range(len(self.addrs)):
                addr = self.addrs[self._slot % len(self.addrs)]
                self._slot += 1
                died = self._dead.get(addr)
                if died is None or now - died > self.dead_cooldown_s:
                    return addr
            return min(self.addrs, key=lambda a: self._dead.get(a, 0.0))

    # -- the runner contract ----------------------------------------------

    def start(self, argv: list, hb_path: str, log_path: str):
        spec = _parse_distext_argv(argv)
        if spec is None:
            return self.base.start(argv, hb_path, log_path)
        addr = self.next_addr()
        self._record_dispatch(spec, addr)
        handle = _RemoteHandle(self, spec, addr, hb_path, log_path)
        return handle

    def _record_dispatch(self, spec: dict, addr: tuple) -> None:
        """wire-<artifact>.json: the remote provenance --status renders
        (worker address, dispatch/speculation counts; the wire-beat age
        is the attempt .hb file's, fed by BEAT frames)."""
        key = spec["final"]
        with self._lock:
            self._dispatches[key] = self._dispatches.get(key, 0) + 1
            live = self._live.get(key, 0)
            if live > 0:
                # a second live session for the same leg IS speculation
                # (or a netfault dup) — first finisher wins either way
                self._speculations[key] = \
                    self._speculations.get(key, 0) + 1
            self._live[key] = live + 1
            row = {"worker": f"{addr[0]}:{addr[1]}",
                   "attempt": spec["attempt"],
                   "dispatches": self._dispatches[key],
                   "speculations": self._speculations.get(key, 0)}
        from ..io.atomic import atomic_write
        try:
            state_dir = os.path.dirname(key) or "."
            with atomic_write(wire_status_path(state_dir, key), "w") as f:
                json.dump(row, f, indent=1, sort_keys=True)
                f.write("\n")
        except OSError:
            pass

    def attempt_done(self, spec_final: str) -> None:
        with self._lock:
            self._live[spec_final] = max(0,
                                         self._live.get(spec_final, 1) - 1)


__all__ = ["RemoteRunner", "wire_status_path"]
