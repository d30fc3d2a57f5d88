"""distext: one leg of the distributed out-of-core build (port of
sheep_tpu/cli/distext.py).

A distext leg STREAMS its contiguous record slice of the whole-input
``.dat`` through the external-memory pipeline (ops/extmem) under its own
``SHEEP_MEM_BUDGET``, so N legs build a graph no single budget can hold.
The tournament supervisor dispatches these
(supervisor/supervise._leg_argv, job kind "distext"); they also run by
hand for rehearsal:

    python -m sheep_tpu_torch.cli.distext hist graph.dat -r 0:500000 \
        -o part00.hist
    python -m sheep_tpu_torch.cli.distext map graph.dat -r 0:500000 \
        -s shared.seq -o part00.tre --checkpoint-dir ck-r0.00 --resume \
        --perf-out r0.00.perf.json

Verbs:
  hist   pass 1: stream the range, accumulate the int64 degree
         histogram per block (native kernel), publish it as a sealed
         ``.hist`` artifact (ops/distext.write_histogram) — the input
         of the supervisor's Allreduce-shaped merge.
  map    pass 2: the ext carry fold over the range, over the SHARED
         sequence (every leg must build in one position space), with
         block-boundary checkpoints in the leg's own dir — the record
         slice is folded into the checkpoint identity, so a resumed
         attempt under a different shard map is refused, never wrong.

``--perf-out`` writes the leg's self-report: the ext perf dict
(read/fold overlap_frac, per-strategy picks, retries) plus this
process's ``obs.metrics.proc_status`` capture (VmRSS, VmHWM where
``/proc`` has it, affinity).

Exit codes: 0 leg complete, 1 failure (typed integrity/resource/IO
errors), 2 usage error.  Torch-free, like everything on the out-of-core
path.
"""

from __future__ import annotations

import getopt
import json
import sys

USAGE = ("USAGE: distext hist|map graph.dat -r start:end -o out "
         "[-s seq_file] [--checkpoint-dir DIR] [--resume] "
         "[--perf-out PATH]")


def _parse_range(spec: str) -> tuple[int, int]:
    a_s, b_s = spec.split(":", 1)
    a, b = int(a_s), int(b_s)
    if a < 0 or b < a:
        raise ValueError(f"range {spec!r} must be 0 <= start <= end")
    return a, b


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from .common import maybe_start_heartbeat
    _hb = maybe_start_heartbeat()  # noqa: F841 — beats while we stream
    try:
        opts, args = getopt.gnu_getopt(
            argv, "r:o:s:v",
            ["checkpoint-dir=", "resume", "perf-out="])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2

    rng = None
    out = ""
    seq_file = ""
    ckpt_dir = None
    resume = False
    perf_out = None
    verbose = False
    for o, a in opts:
        if o == "-r":
            try:
                rng = _parse_range(a)
            except ValueError as exc:
                print(f"distext: {exc}", file=sys.stderr)
                return 2
        elif o == "-o":
            out = a
        elif o == "-s":
            seq_file = a
        elif o == "-v":
            verbose = True
        elif o == "--checkpoint-dir":
            ckpt_dir = a
        elif o == "--resume":
            resume = True
        elif o == "--perf-out":
            perf_out = a

    if len(args) != 2 or args[0] not in ("hist", "map") or not out \
            or rng is None:
        print(USAGE)
        return 2
    verb, graph = args
    if verb == "map" and not seq_file:
        print("distext map: -s seq_file is required (every leg builds "
              "over the shared whole-input sequence)", file=sys.stderr)
        return 2
    a, b = rng

    from ..integrity.errors import IntegrityError
    from ..obs import trace as obs
    from ..resources.errors import ResourceError
    try:
        perf: dict = {}
        with obs.span("distext.leg", verb=verb, start_edge=a, end_edge=b):
            if verb == "hist":
                from ..ops.distext import write_histogram
                from ..ops.extmem import range_degree_histogram
                deg, max_vid, records = range_degree_histogram(
                    graph, start_edge=a, end_edge=b, perf=perf)
                write_histogram(out, deg, records, max_vid, a, b)
                if verbose:
                    print(f"hist [{a}:{b}): {records} records, "
                          f"max_vid {max_vid}", flush=True)
            else:
                from ..io.seqfile import read_sequence
                from ..io.trefile import write_tree
                from ..ops.extmem import build_forest_extmem
                from .graph2tree import _tree_sig
                seq = read_sequence(seq_file)
                seq, forest = build_forest_extmem(
                    graph, seq=seq, start_edge=a, end_edge=b,
                    checkpoint_dir=ckpt_dir, resume=resume, perf=perf)
                write_tree(out, forest.parent, forest.pst_weight,
                           sig=_tree_sig(seq))
                if verbose:
                    print(f"map [{a}:{b}): {perf.get('ext_blocks')} "
                          f"block(s), strategies "
                          f"{perf.get('strategies')}", flush=True)
    except (IntegrityError, ResourceError, OSError, ValueError) as exc:
        print(f"distext {verb}: {exc}", file=sys.stderr)
        return 1
    if perf_out:
        # the leg's self-report: perf + this subprocess's /proc capture
        # (the shared reader, obs/metrics.py) — written ATOMICALLY so a
        # kill mid-report never leaves a torn JSON for the bench to read
        from ..io.atomic import atomic_write
        from ..obs.metrics import proc_status
        with atomic_write(perf_out, "w") as f:
            json.dump({"verb": verb, "range": [a, b], "perf": perf,
                       "proc_status": proc_status()}, f, indent=1,
                      sort_keys=True)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
