"""Worker liveness via heartbeat files + deadlines (port of
sheep_tpu/supervisor/heartbeat.py).

The supervisor and its workers share nothing but a filesystem (the same
contract the phase scripts already poll through, scripts/lib.sh), so
liveness is a file: every worker attempt owns ``<tmp-output>.hb`` and
touches it every ``interval_s`` while it is making progress.  The beat is
the file's **mtime** — which is what makes the protocol trivially
implementable from any worker shape: a Python CLI starts a
:class:`HeartbeatWriter` daemon thread (cli/common.maybe_start_heartbeat,
env ``SHEEP_HEARTBEAT_FILE``), a shell worker runs a background ``touch``
loop (scripts/lib.sh ``sheep_heartbeat_start``).  The content (pid +
wall-clock) is diagnostics only, never parsed for liveness.

The supervisor's side is :func:`last_beat_s`: "when did this attempt last
prove it was alive?" — the heartbeat mtime when one exists, else the
fallback the caller provides (the attempt's launch time; a worker that
never manages its first beat must still be declared dead by deadline, not
trusted forever).  A worker whose beat goes stale past the deadline is
treated as DEAD no matter what its process state says: a hung dispatch, a
livelocked poll loop, and a SIGKILLed process all look the same from the
filesystem, and the recovery (re-dispatch the leg) is the same too.
"""

from __future__ import annotations

import os
import threading
import time

HEARTBEAT_SUFFIX = ".hb"

#: env var a worker checks to know where to beat (set per attempt by the
#: supervisor's subprocess runner; see cli/common.maybe_start_heartbeat)
HEARTBEAT_FILE_ENV = "SHEEP_HEARTBEAT_FILE"
HEARTBEAT_INTERVAL_ENV = "SHEEP_HEARTBEAT_S"

DEFAULT_INTERVAL_S = 1.0


def beat(path: str) -> None:
    """One heartbeat: (re)write ``path`` and bump its mtime.  Plain
    truncate+write, not atomic_write — the mtime is the signal and a torn
    diagnostic payload is harmless, while a tempfile dance would double
    the syscall cost of the hottest liveness operation."""
    with open(path, "w") as f:
        f.write(f"{os.getpid()} {time.time():.3f}\n")


def last_beat_s(path: str, fallback: float) -> float:
    """Wall-clock time of the last beat at ``path``; ``fallback`` (the
    attempt's launch time) when no beat has landed yet."""
    try:
        return os.path.getmtime(path)
    except OSError:
        return fallback


def is_stale(path: str, launched_at: float, deadline_s: float,
             now: float | None = None) -> bool:
    """True when the worker behind ``path`` has not proven liveness within
    ``deadline_s`` — counting from its last beat, or from launch if it
    never beat at all."""
    now = time.time() if now is None else now
    return now - last_beat_s(path, launched_at) > deadline_s


class HeartbeatWriter:
    """Daemon thread beating ``path`` every ``interval_s`` until stopped.

    Used by in-process workers (the supervisor's inline runner) and by the
    CLI mains when the supervisor launched them with
    ``SHEEP_HEARTBEAT_FILE`` in the environment.  Note what this can and
    cannot prove: the thread beats as long as the *process* is scheduled,
    so a worker hung inside one blocking call still beats — that failure
    shape is covered by the supervisor's speculation path (straggler
    re-execution), while the heartbeat deadline covers dead/frozen/
    SIGKILLed processes.
    """

    def __init__(self, path: str, interval_s: float = DEFAULT_INTERVAL_S):
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "HeartbeatWriter":
        beat(self.path)  # first beat lands before any work does
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat:{self.path}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                beat(self.path)
            except OSError:
                return  # state dir removed under us: the run is over

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def maybe_start_from_env() -> HeartbeatWriter | None:
    """Start beating the file named by ``SHEEP_HEARTBEAT_FILE`` (set by the
    supervisor's subprocess runner), if any.  Returns the writer (the CLI
    keeps it alive for the process lifetime) or None."""
    path = os.environ.get(HEARTBEAT_FILE_ENV)
    if not path:
        return None
    interval = float(os.environ.get(HEARTBEAT_INTERVAL_ENV, "")
                     or DEFAULT_INTERVAL_S)
    try:
        return HeartbeatWriter(path, interval).start()
    except OSError:
        return None  # an unwritable heartbeat must not kill the worker
