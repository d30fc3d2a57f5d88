"""worker: run one remote build worker daemon (port of
sheep_tpu/cli/worker.py).

This daemon is the multi-host arm of the distributed out-of-core build:
it accepts ``LEG`` jobs from a distext supervisor over the fleet wire
(serve/worker.py documents the frame shapes), runs the existing
``hist``/``distmap`` leg code over the shipped slice under THIS
process's ``SHEEP_MEM_BUDGET``, and streams the sealed artifact back
crc-checked.  It shares no filesystem with the supervisor — everything
it touches lives in its own state dir.  It is host code: the process
never loads torch.

    python -m sheep_tpu_torch.cli.worker -d wstate/   # ephemeral port;
        # the address is printed and written to <state-dir>/worker.addr
    python -m sheep_tpu_torch.cli.worker -d wstate/ -p 7070 -H 0.0.0.0

Options:
  -d DIR     state dir (required): slices, artifacts, checkpoints,
             worker.addr
  -p PORT    listen port (default 0 = ephemeral)
  -H HOST    bind host (default 127.0.0.1)
  -m MODE    integrity policy for leg checkpoints: strict (default) /
             repair

Env: SHEEP_MEM_BUDGET (each leg folds under the WORKER's budget — the
point of shipping the leg), SHEEP_WORKER_BEAT_S (wire heartbeat
interval), SHEEP_SERVE_NETFAULT_PLAN (worker-wire sites wbeat/wart).

Exit codes: 0 clean shutdown (QUIT verb or SIGTERM/SIGINT), 1 startup
failure, 2 usage error.
"""

from __future__ import annotations

import getopt
import signal
import sys

USAGE = "USAGE: worker -d state_dir [-p port] [-H host] [-m strict|repair]"


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "d:p:H:m:", [])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2

    state_dir = None
    port = 0
    host = "127.0.0.1"
    mode = None
    from ..integrity.sidecar import POLICIES
    for o, a in opts:
        if o == "-d":
            state_dir = a
        elif o == "-p":
            port = int(a)
        elif o == "-H":
            host = a
        elif o == "-m":
            if a not in POLICIES:
                print(f"worker: -m {a!r} must be one of "
                      f"{'/'.join(POLICIES)}")
                return 2
            mode = a

    if state_dir is None or args:
        print(USAGE)
        return 2

    from ..serve.worker import WorkerDaemon
    try:
        daemon = WorkerDaemon(state_dir, host=host, port=port,
                              integrity=mode).start()
    except OSError as exc:
        print(f"worker: {exc}", file=sys.stderr)
        return 1
    h, p = daemon.address
    print(f"worker: listening on {h}:{p}", flush=True)
    print(f"worker: state dir {state_dir} beat={daemon.beat_s}s",
          flush=True)

    def _term(signum, frame):
        daemon.shutdown()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        daemon.run_forever()
    finally:
        daemon.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
