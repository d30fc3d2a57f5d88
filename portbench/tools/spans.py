"""The program's spans in a cell, on the card: each layer's device
seconds, the idle time no layer explains and the longest idle gaps
labelled by layer, from traced runs with the program's spans captured;
or the cost of the capture itself.  The benchmark's own runs never run
this.

    python3 portbench/tools/spans.py --workload lj.build --seeds 11,12 \
        --seconds 30
    python3 portbench/tools/spans.py --workload lj.build --seeds 11,12 \
        --seconds 20 --cost

Traced: each seed is one run of the harness (``run_cell``, traced),
inside ``obs.trace.capture()``; the profiler's raw events are kept and
reduced with the program's ranges taken off the device's rows
(``harness.spans``).  One JSON line a seed: ``correct``, the cell's
per-layer ``metrics`` as the harness reads them, and ``spans``: the
layers' device seconds a build (``harness.spans.LAYER_DEVICE``),
``idle_unattributed_pct``, each span's host and device seconds a build,
the device seconds launched inside no span, which span names reached
the profiler as ranges, the ten longest idle gaps labelled by the
innermost layer span open on each thread (also on standard error), and
the idle seconds with no layer span open, a build, by what the harness's
host sampler saw the threads run then.

Cost: each seed's graph and entry are made once and warmed up, then
four untraced windows run in turns, capture off, on, on, off; one JSON
line a seed with each window's ``records_per_s``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def traced(spec, cell: str, seed: int, seconds: float, device) -> dict:
    from harness import session
    from harness.spans import LAYER_DEVICE, device_only, read_spans
    from sheep_tpu_torch.obs import trace as obs

    kept = {}
    reduce_events = session.reduce_events

    def keeping(events, build_starts=None, sampler=None):
        # the harness's reduction, with the program's ranges taken off
        # the device's rows
        kept.update(events=events, starts=build_starts, sampler=sampler)
        names = {sp.name for sp in cap.spans}
        return reduce_events(device_only(events, names), build_starts,
                             sampler)

    session.reduce_events = keeping
    try:
        with obs.capture() as cap:
            result, lines = session.run_cell(spec, cell, seed, seconds, True,
                                              device, time.perf_counter())
    finally:
        session.reduce_events = reduce_events
    rd = read_spans(kept["events"], cap.spans, kept["starts"],
                    threading.get_ident(), threading.get_native_id())
    # what the host threads ran while no layer span was open
    unexplained: dict = {}
    for a, b in rd.unexplained:
        label = kept["sampler"].label(a - rd.offset, b - rd.offset)
        unexplained[label] = unexplained.get(label, 0.0) + b - a

    def per_build(d: dict) -> dict:
        return {k: rd.per_build(v) for k, v in sorted(d.items())}

    spans = {**per_build({m: rd.layer_device_s.get(m, 0.0)
                          for m in LAYER_DEVICE}),
             "idle_unattributed_pct": rd.idle_unattributed_pct(),
             "busy_s": rd.per_build(rd.busy_s),
             "unattributed_device_s": per_build(rd.unattributed_why),
             "span_host_s": per_build(rd.span_host_s),
             "span_device_s": per_build(rd.span_device_s),
             "profiled": sorted(rd.profiled),
             "not_profiled": sorted(rd.not_profiled),
             # the capture holds the warm-up build's spans too
             "spans_a_build": len(cap.spans) / (rd.builds + 1),
             "idle_gaps": rd.top_gaps(),
             "unexplained_idle_s": dict(sorted(
                 per_build(unexplained).items(), key=lambda kv: -kv[1]))}
    for label, secs in rd.top_gaps():
        print(f"idle gap {secs:.6f} s: {label}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    return {"workload": cell, "seed": seed, "correct": result["correct"],
            "builds": rd.builds, "metrics": {
                k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"], "spans": spans}


def cost(spec, cell_name: str, seed: int, seconds: float, device) -> dict:
    from harness import session
    from harness.graph import make_graph
    from sheep_tpu_torch.obs import trace as obs

    cell = spec.cell(cell_name)
    kind = spec.entry(cell.traffic["entry"])
    graph = make_graph(cell.config["graph"], seed, device)
    entry = kind.make(graph, cell.traffic, device)
    entry.build(None)
    reader = spec.reader("records_per_s")
    got = []
    for mode in ("off", "on", "on", "off"):
        run = session.Run(cell, graph, 0.0)
        with obs.capture() if mode == "on" else contextlib.nullcontext():
            session.run_window(entry, seconds, device, False, run)
        got.append([mode, reader(run), len(run.builds), run.failed])
    return {"workload": cell_name, "seed": seed, "windows": got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from harness.spec import Spec

    if not torch.cuda.is_available():
        print("spans: CUDA is not available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = Spec.load(os.path.dirname(BENCH))
    for seed in (int(s) for s in args.seeds.split(",")):
        fn = cost if args.cost else traced
        print(json.dumps(fn(spec, args.workload, seed, args.seconds,
                            device)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
