#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sheep_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; builds every kernel from the sources in
this checkout.  Phases (any failure raises, so the exit code is non-zero):

1. the card's name and power limit (nvidia-smi);
2. build K1 (csrc/fused_jump.cu), P1 and P2 (csrc/probe_kernels.cu), both
   with nvcc, and the host fold (csrc/host_fold.cpp, g++), in parallel;
3. K1 against its plain torch version on the card: the six
   tests/test_pallas_jump.py cases, a ragged E, and the real-size case
   n = 2^23, E = 2^26 at L = 4 and L = 16 — lo and moved exactly equal;
   kernel_ms / plain_ms (CUDA events, median of 7 after warm-up) and
   bound_ms (bytes over 3.35 TB/s);
4. P1 and P2 against their plain versions at n = 2^18 (the probe's
   default), 2^20 and 2^24, exactly equal, with kernel_ms, plain_ms,
   bound_ms and library_ms timed the same way; then the probe tool's
   ``main`` once at its default size, which must report both kernels
   right and launch both;
5. hep-th golden: build_graph_hybrid and build_graph_device on the card
   print the golden TREEFAQS line and equal the host oracle;
6. real size: build_graph_hybrid on rmat_edges(23, 2^26, seed=0)
   (com-LiveJournal scale) on the default tail, the streamed windowed
   handoff, which must report stream_mode "windowed" and 4 windows, then
   once on the serial arm (SHEEP_STREAM_HANDOFF=0
   SHEEP_OVERLAP_HANDOFF=0); every run equals the host oracle bit for bit;
7. build_graph_device on rmat_edges(20, 2^23, seed=1) equals the oracle;
8. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Every launch count is set to 0 just before each driven path and read just
after: each build must have launched K1, and the probe tool P1 and P2.
Imports nothing of JAX or sheep_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
GOLDEN_TREEFAQS = ("TREEFAQS: width:24\troots:581\n"
                   "\tvheight:754\teheight:2330\n"
                   "\tverts:7610\tedges:15751\n"
                   "\thalo:3532\tcore:0\n"
                   "\tfill:0\n")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device: torch.device, reps: int = 7, warmup: int = 2):
    """Median ms of ``fn`` (CUDA events on the card)."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def build_kernels() -> float:
    from sheep_tpu_torch import native
    from sheep_tpu_torch.buildlib import BUILD_LOGS
    from sheep_tpu_torch.ops import fused_jump, probe

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(fused_jump.load_library),
                pool.submit(probe.load_library),
                pool.submit(native.load_library)]
        for fut in futs:
            fut.result()
    secs = time.perf_counter() - t0
    for name, text in sorted(BUILD_LOGS.items()):
        for line in text.strip().splitlines():
            log(f"build {name}: {line}")
    return secs


def k1_inputs(n: int, e: int, seed: int, device: torch.device):
    """Random links with 20% sentinels (the test_pallas_jump recipe),
    drawn on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    lo = torch.randint(0, n, (e,), generator=g, device=device)
    hi = torch.clamp(lo + torch.randint(1, n, (e,), generator=g,
                                        device=device), max=n)
    dead = torch.rand(e, generator=g, device=device) < 0.2
    lo = torch.where(dead, n, lo).to(torch.int32)
    hi = torch.where(dead, n, hi).to(torch.int32)
    return lo, hi


def per_level(jump, tables, lo, hi):
    for k in range(tables.shape[0]):
        lo = jump(tables[k:k + 1], lo, hi)
    return lo


def k1_case(name: str, lo, hi, n: int, levels: int, device, timed: bool):
    """K1 against fused_descend_plain on one input: exact lo and moved."""
    from sheep_tpu_torch.ops.forest import min_up_table
    from sheep_tpu_torch.ops.fused_jump import (
        fused_descend, fused_descend_plain, jump_group, jump_group_plain,
        lift_tables)

    e = int(lo.shape[0])
    f = min_up_table(lo, hi, n)
    got_lo, got_moved = fused_descend(lo, hi, n, levels, f)
    want_lo, want_moved = fused_descend_plain(lo, hi, n, levels, f)
    err = int((got_lo.long() - want_lo.long()).abs().max()) if e else 0
    equal = torch.equal(got_lo, want_lo) and int(got_moved) == int(want_moved)
    rec = {"case": name, "n": n, "E": e, "L": levels, "equal": equal,
           "max_abs_err": err, "moved": int(got_moved)}
    if timed:
        tables = lift_tables(f, levels)
        rec["kernel_ms"] = time_ms(lambda: jump_group(tables, lo, hi), device)
        rec["plain_ms"] = time_ms(lambda: jump_group_plain(tables, lo, hi),
                                  device)
        # the same kernel launched once per table (level-major order): a
        # measurement of the alternative order, not the main path's
        rec["kernel_per_level_ms"] = time_ms(
            lambda: per_level(jump_group, tables, lo, hi), device)
        rec["bound_ms"] = (8 * e + 4 * e + 4 * levels * (n + 1)) \
            / HBM_BYTES_PER_S * 1e3
    log("k1 " + json.dumps(rec))
    if not equal:
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


def k1_phase(device: torch.device, real_log_n: int = 23,
             real_log_e: int = 26, ragged_e: int = 1_000_003):
    recs = []
    for trial in range(6):  # tests/test_pallas_jump.py cases, same draws
        rng = np.random.default_rng(600 + trial)
        n = int(rng.integers(50, 4000))
        e = int(rng.integers(10, 20000))
        lo_np = rng.integers(0, n, e)
        hi_np = np.minimum(lo_np + rng.integers(1, n, e), n)
        dead = rng.random(e) < 0.2
        lo_np[dead] = n
        hi_np[dead] = n
        levels = int(rng.integers(1, 11))
        lo = torch.from_numpy(lo_np.astype(np.int32)).to(device)
        hi = torch.from_numpy(hi_np.astype(np.int32)).to(device)
        recs.append(k1_case(f"pallas_jump_{trial}", lo, hi, n, levels,
                            device, timed=False))
    n = 1 << 20
    lo, hi = k1_inputs(n, ragged_e, 7, device)
    recs.append(k1_case("ragged", lo, hi, n, 10, device, timed=True))
    n = 1 << real_log_n
    lo, hi = k1_inputs(n, 1 << real_log_e, 8, device)
    for levels in (4, 16):
        recs.append(k1_case(f"real_L{levels}", lo, hi, n, levels, device,
                            timed=True))
    del lo, hi
    return recs


def forest_equal(seq, forest, want_seq, want) -> bool:
    return (np.array_equal(seq, want_seq)
            and np.array_equal(forest.parent, want.parent)
            and np.array_equal(forest.pst_weight, want.pst_weight))


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from sheep_tpu_torch.ops import fused_jump, probe

    fused_jump.launches = 0
    for name in probe.launches:
        probe.launches[name] = 0


def read_counts() -> dict:
    from sheep_tpu_torch.ops import fused_jump, probe

    return {"fused_jump": fused_jump.launches, **probe.launches}


def counted_build(fn, what: str):
    """Run one build with every count set to 0 just before it and read
    just after; the build must have launched K1."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["fused_jump"]
    if launches <= 0:
        raise AssertionError(f"{what}: K1 was not launched on the main path")
    return out, wall, launches


def probe_case(name: str, n: int, kernel, plain, args, device,
               bytes_moved: int, library=None):
    """One probe kernel against its plain version on one input: exactly
    equal, then kernel_ms, plain_ms and library_ms (median of 7 after
    warm-up) and bound_ms (bytes over the card's memory rate)."""
    got = kernel(*args)
    want = plain(*args)
    equal = torch.equal(got, want)
    err = int((got.long() - want.long()).abs().max())
    rec = {"kernel": name, "n": n, "equal": equal, "max_abs_err": err,
           "kernel_ms": time_ms(lambda: kernel(*args), device),
           "plain_ms": time_ms(lambda: plain(*args), device),
           "library_ms": time_ms(lambda: library(*args), device)
           if library is not None else None,
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3}
    log("probe " + json.dumps(rec))
    if not equal:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rec}")
    return rec


def probe_phase(device: torch.device, log_ns=(18, 20, 24)):
    """P1 and P2 against their plain versions, then the probe tool's
    main path with the counts set to 0 just before it."""
    from sheep_tpu_torch.ops import probe
    from sheep_tpu_torch.scripts import kernel_probe

    recs = []
    for log_n in log_ns:
        n = 1 << log_n
        x = torch.arange(n, dtype=torch.int32, device=device).reshape(
            n // 256, 256)
        # the library yardstick for P1 is the one PyTorch call x + 1,
        # which is also P1's plain version
        recs.append(probe_case("add_one", n, probe.add_one,
                               probe.add_one_plain, (x,), device, 8 * n,
                               library=lambda a: a + 1))
        args = kernel_probe.probe_inputs(n, device)
        recs.append(probe_case("jump_step", n, probe.jump_step,
                               probe.jump_step_plain, args, device, 16 * n))
        del x, args
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = kernel_probe.main(["--device", str(device)])
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    text = buf.getvalue().strip()
    log(f"probe tool (rc={rc}): {text}")
    rec = json.loads(text.splitlines()[-1])
    if rc != 0 or rec.get("trivial_kernel") != "ok" \
            or rec.get("jump_kernel_correct") is not True:
        raise AssertionError(f"the probe tool failed: rc={rc} {rec}")
    if counts["add_one"] <= 0 or counts["jump_step"] <= 0:
        raise AssertionError(f"the probe tool did not launch P1 and P2: "
                             f"{counts}")
    log(f"probe tool launches: {json.dumps(counts)}")
    return recs, rec, counts


def golden_phase(device: torch.device):
    from sheep_tpu_torch.core import (build_forest, compute_facts,
                                      degree_sequence)
    from sheep_tpu_torch.io import load_edges
    from sheep_tpu_torch.ops.build import (build_graph_device,
                                           build_graph_hybrid)

    el = load_edges(os.path.join(ROOT, "data", "hep-th.dat"))
    want_seq = degree_sequence(el.tail, el.head)
    want = build_forest(el.tail, el.head, want_seq)
    out = {}
    for name, build in (("hybrid", build_graph_hybrid),
                        ("device", build_graph_device)):
        perf: dict = {}
        kw = {"perf": perf} if name == "hybrid" else {}
        (seq, forest), wall, launches = counted_build(
            lambda: build(el.tail, el.head, device=device, **kw),
            f"hep-th {name}")
        if str(perf.get("stream_mode", "")).startswith("fallback"):
            raise AssertionError(f"hep-th hybrid: the streamed tail failed "
                                 f"over to the serial fetch: {perf}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            compute_facts(forest).print()
        text = buf.getvalue()
        log(f"hep-th {name}: {text.strip()}".replace("\n", " /"))
        if text != GOLDEN_TREEFAQS:
            raise AssertionError(f"hep-th {name}: TREEFAQS differs from the "
                                 f"golden line:\n{text}")
        if not forest_equal(seq, forest, want_seq, want):
            raise AssertionError(f"hep-th {name}: differs from the oracle")
        out[name] = {"wall_s": wall, "k1_launches": launches}
        log(f"hep-th {name}: equal to the host oracle, wall_s={wall:.4f} "
            f"k1_launches={launches}")
    return out


def oracle(tail, head):
    from sheep_tpu_torch.core import build_forest, degree_sequence

    t0 = time.perf_counter()
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    return want_seq, want, time.perf_counter() - t0


#: the serial arm's knobs (the reference's SHEEP_STREAM_HANDOFF=0
#: SHEEP_OVERLAP_HANDOFF=0)
SERIAL_ARM = {"SHEEP_STREAM_HANDOFF": "0", "SHEEP_OVERLAP_HANDOFF": "0"}


@contextlib.contextmanager
def env_set(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def real_size_phase(device: torch.device, log_n: int = 23,
                    log_e: int = 26, runs: int = 2, windows: int = 4):
    from sheep_tpu_torch.ops.build import build_graph_hybrid
    from sheep_tpu_torch.utils import rmat_edges

    t0 = time.perf_counter()
    tail, head = rmat_edges(log_n, 1 << log_e, seed=0)
    log(f"real: rmat_edges({log_n}, 2^{log_e}, seed=0) in "
        f"{time.perf_counter() - t0:.2f}s")
    want_seq, want, oracle_s = oracle(tail, head)
    log(f"real: host oracle in {oracle_s:.2f}s, m={len(want_seq)}")
    recs = []
    # the default tail (streamed) runs first and last, the serial arm
    # between, so the two arms meet on one card in turns
    arms = ["stream"] * (runs - 1) + ["serial", "stream"]
    for run, arm in enumerate(arms):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        perf: dict = {}
        with env_set(SERIAL_ARM if arm == "serial" else {}):
            (seq, forest), wall, launches = counted_build(
                lambda: build_graph_hybrid(tail, head, device=device,
                                           perf=perf),
                f"real-size hybrid ({arm})")
        if not forest_equal(seq, forest, want_seq, want):
            raise AssertionError(f"real-size hybrid ({arm}) differs from "
                                 f"the oracle")
        rec = {"run": run, "arm": arm, "records": len(tail), "wall_s": wall,
               "records_per_s": len(tail) / wall,
               "k1_launches": launches, **perf}
        if device.type == "cuda":
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log("real hybrid " + json.dumps(rec))
        if arm == "stream" and (perf.get("stream_mode") != "windowed"
                                or perf.get("fetch_windows") != windows):
            raise AssertionError(
                f"real-size hybrid: the default tail did not stream "
                f"{windows} windows: stream_mode="
                f"{perf.get('stream_mode')} "
                f"fetch_windows={perf.get('fetch_windows')}")
        recs.append(rec)
    return recs


def device_phase(device: torch.device, log_n: int = 20, log_e: int = 23):
    from sheep_tpu_torch.ops.build import build_graph_device
    from sheep_tpu_torch.utils import rmat_edges

    tail, head = rmat_edges(log_n, 1 << log_e, seed=1)
    want_seq, want, _ = oracle(tail, head)
    (seq, forest), wall, launches = counted_build(
        lambda: build_graph_device(tail, head, device=device),
        "full device build")
    if not forest_equal(seq, forest, want_seq, want):
        raise AssertionError("full device build differs from the oracle")
    rec = {"records": len(tail), "wall_s": wall, "k1_launches": launches}
    log("device build " + json.dumps(rec))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} ({kind}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(f"build: K1, P1/P2 and host fold in {build_kernels():.2f}s")
    k1 = k1_phase(device)
    probes, _, probe_counts = probe_phase(device)
    golden_phase(device)
    real = real_size_phase(device)
    device_phase(device)
    main_run = real[-1]
    timed = next(r for r in k1 if r["case"] == "real_L4")
    kernels = [{
        "name": "fused_jump", "route": "cuda",
        "source": "sheep_tpu_torch/csrc/fused_jump.cu",
        "replaces": "sheep_tpu/ops/pallas_jump.py:77",
        "plain": "fused_descend_plain",
        "equal": all(r["equal"] for r in k1),
        "launches": main_run["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k1),
        "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "case": f"n={timed['n']} E={timed['E']} L={timed['L']}",
    }]
    probe_kernels = (
        ("add_one", "add_one_plain", "scripts/pallas_probe.py:42",
         "one PyTorch call, x + 1 (also the plain version)"),
        ("jump_step", "jump_step_plain", "scripts/pallas_probe.py:74",
         "none: a gather, a compare and a select are three calls"))
    for name, plain, replaces, library in probe_kernels:
        cases = [r for r in probes if r["kernel"] == name]
        big = max(cases, key=lambda r: r["n"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "sheep_tpu_torch/csrc/probe_kernels.cu",
            "replaces": replaces, "plain": plain,
            "equal": all(r["equal"] for r in cases),
            "launches": probe_counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": big["kernel_ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": "bytes",
            "library_ms": big["library_ms"], "library": library,
            "case": f"n={big['n']}",
        })
    log(json.dumps({"kernels": kernels}))
    log(card)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
