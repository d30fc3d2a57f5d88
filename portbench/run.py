"""The benchmark of sheep_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload lj.build --seed 7 --seconds 51 \
        --trace 0

run from the root of a checkout on a machine with the cards the cell
asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``check``: each number
compared with the reference, beside its limit.  The same numbers are
the last lines of standard error.  Without CUDA, with fewer cards than
the cell asks for, without the program, or with JAX or the JAX package
loaded once the window has closed, the run prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    from harness.session import cache_dirs
    for key, path in cache_dirs(ROOT).items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    import torch

    from harness.spec import Spec
    spec = Spec.load(ROOT)
    chips = next((w["chips"] for w in spec.bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        return fail(f"no cell {args.workload!r}; cells: "
                    f"{spec.cell_names()}", 2)
    if not torch.cuda.is_available():
        return fail("CUDA is not available; the benchmark runs on the card "
                    "only", 3)
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, "
                    f"{torch.cuda.device_count()} found", 3)
    try:
        import sheep_tpu_torch  # noqa: F401
    except ImportError as exc:
        return fail(f"the program is missing: {exc}", 4)
    from harness.session import forbidden_modules, run_cell
    result, lines = run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_PROCESS)
    loaded = forbidden_modules()
    if loaded:
        return fail(f"modules that no run may load are loaded: {loaded}", 5)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
