"""plan: resolve and explain a build's execution plan (port of
sheep_tpu/cli/plan.py).

The operational face of the planner: BEFORE the run, which rung would
run, at what priced (and history-corrected) cost, and which ``SHEEP_*``
knob decided each part of the plan::

    python -m sheep_tpu_torch.cli.plan --explain g.dat
                                      # plan the build of g.dat
    python -m sheep_tpu_torch.cli.plan --explain -n 1048576 -e 4194304
                                      # plan a hypothetical size
    python -m sheep_tpu_torch.cli.plan --explain --json g.dat
                                      # machine-readable
    python -m sheep_tpu_torch.cli.plan --harvest prior.store run.trace \
        EXTBENCH_r01.json             # learn priors from history

Inputs: a ``.dat`` file (one streaming histogram pass derives n and the
record count — the same pass-1 arithmetic the ext build runs), or
``-n``/``-e`` for a hypothetical build.  The plan reads the same env
the build would (budgets, knobs, ``SHEEP_PLAN_PRIORS``), so running it
in a build's environment answers for THAT build.

``--assume-rss BYTES`` pins the measured-RSS input of the headroom
arithmetic, making the plan a pure function of its inputs (the same plan
twice gives byte-equal output).  ``--harvest`` folds trace files
(rotated segment chains included; a torn newest segment is legal
evidence) and bench records into a prior store for
``SHEEP_PLAN_PRIORS``.

Exit codes: 0 planned/harvested, 1 unreadable input, 2 usage error.
The tool is host code and loads no torch.
"""

from __future__ import annotations

import getopt
import json
import os
import sys

USAGE = ("USAGE: plan [--explain] [--json] [-n N] [-e EDGES] [-w WORKERS]\n"
         "            [--assume-rss BYTES] [--priors STORE] [graph.dat]\n"
         "       plan --harvest STORE <trace|bench.json>...")


def _harvest(store_path: str, inputs: list[str]) -> int:
    from ..plan import PriorStore
    store = PriorStore(store_path)
    total = 0
    for p in inputs:
        if not os.path.exists(p):
            print(f"plan: {p}: no such file", file=sys.stderr)
            return 1
        if p.endswith(".json"):
            got = store.harvest_bench(p)
        else:
            got = store.harvest_trace(p)
        print(f"harvested {got:>4} sample(s) from {p}")
        total += got
    store.save(store_path)
    print(f"{store_path}: {len(store)} prior(s) ({total} new sample(s))")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(
            argv, "n:e:w:",
            ["explain", "json", "harvest=", "priors=", "assume-rss="])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2
    as_json = False
    harvest_store = None
    priors_path = None
    assume_rss = None
    n = edges = None
    workers = None
    for o, a in opts:
        if o == "--json":
            as_json = True
        elif o == "--harvest":
            harvest_store = a
        elif o == "--priors":
            priors_path = a
        elif o == "--assume-rss":
            assume_rss = int(a)
        elif o == "-n":
            n = int(a)
        elif o == "-e":
            edges = int(a)
        elif o == "-w":
            workers = int(a)
        # --explain is the default (and only) render mode; accepted for
        # the ROADMAP's spelling of the command

    if harvest_store is not None:
        if not args:
            print(USAGE)
            return 2
        return _harvest(harvest_store, args)

    edges_path = None
    if args:
        if len(args) != 1:
            print(USAGE)
            return 2
        edges_path = args[0]
        if not os.path.exists(edges_path):
            print(f"plan: {edges_path}: no such file", file=sys.stderr)
            return 1
        if not edges_path.endswith(".dat"):
            print(f"plan: {edges_path}: only .dat record streams can be "
                  f"planned from the file alone (use -n/-e)",
                  file=sys.stderr)
            return 1
        if n is None or edges is None:
            # pass-1 arithmetic: one streaming histogram derives the
            # position-space size and record count without loading the
            # edge list (the exact pass the ext build would run)
            from ..ops.extmem import dat_num_records, range_degree_histogram
            records = dat_num_records(edges_path)
            if edges is None:
                edges = records
            if n is None:
                deg, _, _ = range_degree_histogram(edges_path)
                n = int((deg > 0).sum())
    if n is None:
        print(USAGE)
        return 2
    if edges is None:
        edges = 4 * n

    from ..plan import PriorStore, plan_build
    priors = PriorStore(priors_path) if priors_path else None
    plan = plan_build(int(n), int(edges),
                      num_workers=workers, devices=1,
                      edges_path=edges_path, priors=priors,
                      assume_rss=assume_rss,
                      with_distext=edges_path is not None)
    if as_json:
        json.dump(plan.to_dict(), sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write("\n".join(plan.explain()) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
