"""Backend probe: does the card run a hand-written kernel at all, and how
does one level of the pointer jump run as a kernel against plain torch.
The port's counterpart of scripts/pallas_probe.py.

Stage 1: kernel P1 (``ops.probe.add_one``) on arange(n) as [n/256, 256];
the check is sum(out) == sum(x) + n.  If it fails, stage 2 does not run.
Stage 2: kernel P2 (``ops.probe.jump_step``) against its plain torch
version on the probe's input recipe (numpy ``default_rng(0)``): equality,
and each one's time, the minimum of 3 runs after a warm-up (CUDA events
on the card, the host clock on the CPU).

    python -m sheep_tpu_torch.scripts.kernel_probe [LOG_N] [--device cpu]

LOG_N defaults to 18; the device to the CUDA card (on the CPU the
"kernels" are their plain versions).  Prints one JSON record: platform,
device, log_n, trivial_kernel, jump_torch_ms, jump_kernel_correct,
jump_kernel_ms.  An exception's text goes into the record, and then, as
for a wrong result, the exit code is 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import probe


def probe_inputs(n: int, device):
    """Stage 2's inputs (scripts/pallas_probe.py's recipe): f[i] = min(i +
    U[1, 64), n - 1), lo ~ U[0, n), hi = min(lo + U[1, 1024), n)."""
    rng = np.random.default_rng(0)
    f = np.minimum(np.arange(n) + rng.integers(1, 64, n), n - 1)
    lo = rng.integers(0, n, n)
    hi = np.minimum(lo + rng.integers(1, 1024, n), n)
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (f, lo, hi))


def min_ms(fn, device: torch.device, reps: int = 3) -> float:
    """The fastest of ``reps`` runs of ``fn`` after one warm-up, in ms."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def run_probe(log_n: int, device: torch.device, rec: dict) -> None:
    """Fill ``rec`` with both stages' results; raises on a failure."""
    n = 1 << log_n
    x = torch.arange(n, dtype=torch.int32, device=device).reshape(
        n // 256, 256)
    out = probe.dispatch(probe.add_one, probe.add_one_plain, x)
    ok = int(out.sum()) == int(x.sum()) + n
    rec["trivial_kernel"] = "ok" if ok else "WRONG RESULT"
    if not ok:
        return
    f, lo, hi = probe_inputs(n, device)
    rec["jump_torch_ms"] = min_ms(
        lambda: probe.jump_step_plain(f, lo, hi), device)
    got = probe.dispatch(probe.jump_step, probe.jump_step_plain, f, lo, hi)
    rec["jump_kernel_correct"] = bool(
        torch.equal(got, probe.jump_step_plain(f, lo, hi)))
    rec["jump_kernel_ms"] = min_ms(
        lambda: probe.dispatch(probe.jump_step, probe.jump_step_plain,
                               f, lo, hi), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", nargs="?", type=int, default=18,
                    help="probe 2^LOG_N elements (default 18, at least 8)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default the card")
    args = ap.parse_args(argv)
    rec: dict = {"log_n": args.log_n}
    try:
        if args.log_n < 8:
            raise ValueError("LOG_N must be at least 8 (rows of 256)")
        device = resolve_device(args.device)
        rec["platform"] = "gpu" if device.type == "cuda" else "cpu"
        rec["device"] = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        run_probe(args.log_n, device, rec)
    except Exception as exc:  # the record says what failed; exit 1
        rec.setdefault("trivial_kernel",
                       f"{type(exc).__name__}: {str(exc)[:200]}")
        rec["error"] = f"{type(exc).__name__}: {str(exc)[:200]}"
    print(json.dumps(rec), flush=True)
    ok = rec.get("trivial_kernel") == "ok" \
        and rec.get("jump_kernel_correct") is True and "error" not in rec
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
