"""supervise: the chaos-hardened distributed tournament driver (port of
sheep_tpu/cli/supervise.py).

The operational face of sheep_tpu_torch.supervisor: it owns the
sort -> map -> merge-tournament lifecycle of the distributed file path
and survives any single-point failure (dead/hung/straggling workers,
corrupted artifacts, its own death — rerun with the same -d to resume):

    python -m sheep_tpu_torch.cli.supervise graph.dat -w 8 -d state/ \
        -o graph.tre
    python -m sheep_tpu_torch.cli.supervise graph.dat -w 8 -d state/ \
        -o graph.tre   # resumes

Every leg is the port's own tool as a process of its own (``python -m
sheep_tpu_torch.cli.<tool>``); none of them, and not the supervisor,
loads torch.

Options:
  -d DIR     state dir: manifest + intermediate artifacts + worker logs
             (default: <graph>.supervisor).  Rerunning with the same dir
             fscks the surviving artifacts and re-dispatches only the
             dirty/missing legs.
  -w N       tournament width (map workers; default SHEEP_WORKERS or 2)
  -r N       tournament fan-in (default REDUCTION or 2)
  -s SEQ     existing sequence file to build over (skip the sort phase)
  -o OUT     final tree path (default <state-dir>/<base>.tre)
  -t SEC     heartbeat deadline (default SHEEP_DEADLINE_S or 30)
  -v         echo the event trace as it happens
  --status   read-only operator report of the state dir (leg states,
             dispatch counts, heartbeat ages, disk/mem budget headroom,
             and — for distext jobs — per-leg ext progress as blocks
             done/total from each leg's own checkpoint —
             supervisor/status.py) instead of running anything
  --json     with --status: emit the report as one JSON object so
             outside monitors consume it without scraping the table

Exit codes: 0 tournament complete, 1 failure (budget spent / bad state
dir), 2 usage error.  SHEEP_FAULT_PLAN (see supervisor/chaos.py) injects
deterministic faults, SHEEP_IO_FAULT_PLAN (io/faultfs.py) injects
ENOSPC/EIO/short/slow at any write site, and SHEEP_MEM_BUDGET /
SHEEP_DISK_BUDGET / SHEEP_LEG_CORES bound what a run may consume —
operators can rehearse a recovery before trusting a multi-hour run to it.
"""

from __future__ import annotations

import getopt
import sys

from ..integrity.errors import IntegrityError
from ..supervisor import (SupervisionFailed, SupervisorConfig,
                          SupervisorKilled, run_supervised)

USAGE = ("USAGE: supervise graph [-d state_dir] [-w workers] [-r reduction]"
         " [-s seq_file] [-o out_tree] [-t deadline_s] [-v] "
         "[--status [--json]]")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "d:w:r:s:o:t:v",
                                       ["status", "json"])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2

    state_dir = None
    seq_file = None
    out_file = None
    verbose = False
    status = False
    as_json = False
    overrides: dict = {}
    for o, a in opts:
        if o == "-d":
            state_dir = a
        elif o == "-w":
            overrides["workers"] = int(a)
        elif o == "-r":
            overrides["reduction"] = int(a)
        elif o == "-s":
            seq_file = a
        elif o == "-o":
            out_file = a
        elif o == "-t":
            overrides["deadline_s"] = float(a)
        elif o == "-v":
            verbose = True
        elif o == "--status":
            status = True
        elif o == "--json":
            as_json = True

    if status:
        # --status needs a state dir: given directly, or derived from the
        # graph argument the way a run would derive it
        if state_dir is None and len(args) == 1:
            state_dir = args[0] + ".supervisor"
        if state_dir is None:
            print(USAGE)
            return 2
        from ..supervisor.status import main_status
        return main_status(state_dir, as_json=as_json)

    if as_json:
        print("supervise: --json only applies to --status")
        return 2

    if len(args) != 1:
        print(USAGE)
        return 2
    graph = args[0]
    state_dir = state_dir or graph + ".supervisor"

    try:
        config = SupervisorConfig.from_env(**overrides)
    except ValueError as exc:
        print(f"supervise: {exc}", file=sys.stderr)
        return 2

    if verbose:
        class _Echo(list):
            def append(self, item):
                print(f"supervise: {' '.join(str(x) for x in item)}",
                      flush=True)
                super().append(item)
        config.events = _Echo()

    try:
        manifest = run_supervised(graph, state_dir, config,
                                  seq_file=seq_file, out_file=out_file)
    except (SupervisionFailed, SupervisorKilled, IntegrityError,
            OSError) as exc:
        print(f"supervise: {exc}", file=sys.stderr)
        return 1
    dispatches = sum(leg.dispatches for leg in manifest.legs)
    print(f"supervise: {len(manifest.legs)} leg(s) complete in "
          f"{dispatches} dispatch(es); tree at "
          f"{out_file or manifest.final_tree}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
