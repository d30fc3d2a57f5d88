"""Readings of the check on many seeds in one process, on the card: for
each seed, the cell's graph, one build of the program and each named
control in the program's place, all compared with the reference at the
cell's own size.  The benchmark's own runs never run this.

    python3 portbench/tools/readings.py --workload lj.build \
        --seeds 11,12,13 --controls dedupe,ties [--program]

One JSON line per seed and side: {"workload", "seed", "side", "n" (the
reference's vertices of nonzero degree), "correct", "check", ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from harness import check
    from harness.controls import Control
    from harness.graph import make_graph
    from harness.spec import Spec

    if not torch.cuda.is_available():
        print("readings: CUDA is not available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = Spec.load(os.path.dirname(BENCH))
    cell = spec.cell(args.workload)
    kind = spec.entry(cell.traffic["entry"])
    for seed in (int(s) for s in args.seeds.split(",")):
        graph = make_graph(cell.config["graph"], seed, device)
        entry = kind.make(graph, cell.traffic, device)
        sides = [("program", entry)] if args.program else []
        sides += [(k, Control(entry, k)) for k in args.controls.split(",")
                  if k]
        got = {}
        for name, side in sides:
            t0 = time.perf_counter()
            got[name] = (side.build(None), time.perf_counter() - t0)
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        want = kind.expected(graph, cell.traffic, device)
        ref_s = time.perf_counter() - t0
        for name, (out, secs) in got.items():
            numbers = check.compare([out], 0, want, kind.LIMITS)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "side": name,
                "n": len(want["seq"]), "correct": check.passes(numbers, 1),
                "check": {k: v for k, (v, _) in numbers.items()},
                "side_s": round(secs, 3), "reference_s": round(ref_s, 3)}),
                flush=True)
        del entry, sides, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
