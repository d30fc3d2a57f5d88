#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sheep_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; builds every kernel from the sources in
this checkout.  Phases (any failure raises, so the exit code is non-zero):

1. the card's name and power limit (nvidia-smi);
2. build K1 (csrc/fused_jump.cu), P1 and P2 (csrc/probe_kernels.cu), both
   with nvcc, and the native host runtime (csrc/sheep_native.cpp, g++
   with OpenMP), in parallel;
3. K1 against its plain torch version on the card: the six
   tests/test_pallas_jump.py cases, a ragged E, groupings forced to
   g = 1, 2 and L tables a launch (a small ``l2_bytes`` to the planner)
   on aligned, offset (storage offset 1-3) and E % 4 != 0 inputs,
   random links at E = 2^26, L = 4 for n = 2^21 and 2^22, and the
   real-size case n = 2^23, E = 2^26 at L = 4 and L = 16 — lo and
   moved exactly equal, and one launch per planned group; three orders
   (planned groups, one pass over all L tables, one launch per table)
   and the plain version timed in turns (CUDA events around 10 calls
   back to back, median of 7 after warm-up), with bound_ms (bytes over
   3.35 TB/s);
4. P1 and P2 against their plain versions at n = 2^18 (the probe's
   default), 2^20 and 2^24, and P1 also at 2^24 + 3 and on views at
   storage offsets 1-3, exactly equal, with kernel_ms, plain_ms,
   bound_ms and library_ms timed the same way.  P2 (also at 2^22) with
   one torch.gather beside it (gather_only_ms, the floor of any
   gather-based version), and at 2^24 + 3, on views at offsets 1-3 and
   with lo below 0 and at or past the width on the int4 and scalar
   paths.  Then the probe tool's ``main`` once at its default size,
   which must report both kernels right and launch both;
5. hep-th golden: build_graph_hybrid and build_graph_device on the card
   print the golden TREEFAQS line and equal the host oracle;
6. real size: build_graph_hybrid on rmat_edges(23, 2^26, seed=0)
   (com-LiveJournal scale) on the default tail, the streamed windowed
   handoff, which must report stream_mode "windowed" and 4 windows, once
   on the serial arm (SHEEP_STREAM_HANDOFF=0 SHEEP_OVERLAP_HANDOFF=0),
   again on the default tail, then on the speculative arm
   (SHEEP_STREAM_HANDOFF=0, the overlap at its CUDA default), which must
   report its spec_mode and spec_starts; every run equals the host oracle
   bit for bit.  The first run records the shape (width, E, L, sorted or
   not, groups) and device time of every K1 call and keeps the first
   chunk round's input, on which K1's three orders are then timed against
   the plain version as in phase 3;
6b. the native host runtime (``native`` line) on the real-size graph:
   the numpy degree order against the fused native sort, the blocked
   fused build against edges_to_links + the plain fold, the links fold on
   1 thread and on the host's granted cores (which it must use), and the
   hybrid with the numpy order forced into its prefetch and with the
   native one, each equal to the oracle, with prefetch_seq_s,
   prefetch_pst_s, pst_wait_s and fold_s; the host's cores and the
   OpenMP runtimes mapped into the process;
7. the speculative arm forced, through its seams, to hand off the
   snapshot its side stream fetched: spec_complete (the stream stops the
   loop) and spec_wait, each 6-byte packed and in int32 pairs, on
   rmat_edges(18, 2^21, seed=2), each equal to the oracle;
8. the spec arm's fetch thread alone: 2^24 random links at n = 2^23
   fetched in slices of 2^18 and 2^21 links, equal to the snapshot, with
   its breakdown (pinned allocation, copy enqueue, event wait, the
   copies' device time) and rate;
9. the out-of-core builds: build_graph_streaming_hosted and
   build_graph_streaming on hep-th in blocks of 4096 (the golden
   TREEFAQS line), build_graph_streaming on rmat_edges(20, 2^23, seed=1)
   in 4 blocks, and build_graph_streaming_hosted on the real-size graph
   in blocks of 2^24 records, each equal to the oracle;
9b. the partitioner (``partition`` line): hep-th built by
   build_graph_hybrid on the card (K1 counted), partitioned at 2-9 parts
   with ECV(down) equal to data/hepth-ecv-baseline.json and the golden
   2-part report (edges cut 2811, Vcom 2061, ECV(hash) 1311, ECV(down)
   521, ECV(up) 1539, sizes 3409/4201); four partial hep-th forests
   built on the card over one sequence (K1 counted), merged by
   merge_forests to the whole tree; the native forward pass against the
   python one on rmat_edges(20, 2^23, seed=1) at 2, 16 and 64 parts; the
   real-size tree partitioned at 2, 16 and 64 parts and evaluated at 2
   and 64, the in-memory evaluator equal to the streamed one, the
   partition and both evaluators timed;
9c. the CLI (``cli`` line), the user's entry point: ``graph2tree
   data/hep-th.dat -i -r -f -c`` on the card in process (the golden
   TREEFAQS line, ``Tree is valid.``, K1 counted) and as a process of its
   own (``python -m sheep_tpu_torch.cli.graph2tree``), the same bytes;
   ``-r -s SEQ``, the serial tool and ``merge_trees`` over ``-l 1/2`` and
   ``-l 2/2``, the ``-i -s S -o P`` map route's ``P00r0.tre`` and
   ``--checkpoint-dir`` all the same ``.tre`` and sidecar bytes;
   ``partition_tree -f -g`` at 2 parts (ECV(down) 521, edges cut 2811,
   sizes 3409 and 4201).  Then, in a temporary directory, ``make_graph 23
   8 G.dat 0`` (the records of phase 6's graph; its load timed strict,
   the sidecar crc included, against trust, in turns), ``degree_sequence``,
   ``graph2tree G.dat -i -r -s S2.seq -o T.tre`` (K1 counted in its
   process; S2.seq equal to the tool's sequence, T.tre to the oracle bit
   for bit), ``partition_tree S.seq T.tre 2 16 64`` and, with
   SHEEP_EVAL_STREAM=1, ``partition_tree -g`` at 2 parts (ECV(down) equal
   to phase 9b's), each process timed;
10. the fault-tolerant build (``runtime.build_graph_resilient``, ladder
    single -> host -> stream -> spill, checkpoints in a temporary
    directory) on the real-size graph: equal to the oracle, no degrade,
    K1 launched on the single rung; wall beside the streamed hybrid's of
    phase 6, prep/rung/enqueue seconds from the build's own trace
    (SHEEP_TRACE), the loop's device waits, boundary fetches, host
    assists and remaps, each snapshot's seconds and bytes, peak device
    memory;
11. build_graph_device on rmat_edges(20, 2^23, seed=1) equals the oracle;
12. the fault-tolerant build on that graph: a kill at every checkpoint
    boundary in turn, each resumed to the uninterrupted forest with a
    ``resume`` event; an injected chunk fault twice (retries); a forced
    degrade single -> host; a dispatch raising a real CUDA out-of-memory
    error (retried, exhausted, degraded); a dispatch held on the card
    (torch.cuda._sleep) past a 0.5 s watchdog; each equal to the oracle;
    no resume degrades, and each resume on the single rung launches K1;
    K1 failing to launch fails the build with no retry and no degrade
    (``resilient {...}`` lines);
13. a ``kernels`` JSON line, the card's name and power limit, then the
    result line ``{"ok": true, "device": {...}}`` last.

Every launch count is set to 0 just before each driven path and read just
after: each build (the streaming builds and the unfaulted resilient
builds too) must have launched K1, and the probe tool P1 and P2.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
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


def build_kernels() -> float:
    """Build every native library in parallel and print ptxas's report;
    a kernel that spills registers fails the run."""
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
    spills = []
    for name, text in sorted(BUILD_LOGS.items()):
        for line in text.strip().splitlines():
            log(f"build {name}: {line}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if found and found.groups() != ("0", "0"):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    return secs


def time_turns(fns: dict, device: torch.device, reps: int = 7,
               batch: int = 10, warmup: int = 2) -> dict:
    """Median ms of one call of each of ``fns`` (name -> callable), run in
    turns: each repetition runs every function ``batch`` times back to
    back between its own CUDA events (host clock on the CPU), so the
    card's queue hides the host's launch cost and the events time the
    device; a sample is the pair's time over ``batch``."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    for _ in range(reps):
        for name, fn in fns.items():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            if cuda:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                ms = (time.perf_counter() - t0) * 1e3
            times[name].append(ms / batch)
    return {name: statistics.median(t) for name, t in times.items()}


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


def k1_bound_ms(e: int, levels: int, width: int) -> float:
    """K1's least time: lo, hi read and out written once (12 bytes a
    link), each table read once, over the card's memory rate."""
    return (12 * e + 4 * levels * width) / HBM_BYTES_PER_S * 1e3


def k1_orders(tables, lo, hi, device, sorted_links: bool = False) -> dict:
    """K1's three orders on one input, each exactly equal to
    jump_group_plain and timed in turns with it: the planned groups (the
    main path's order: one pass for sorted links, else L2-sized groups),
    one pass over all tables, and one launch per table."""
    from sheep_tpu_torch.ops.fused_jump import (
        descend_groups, jump_group_cuda, jump_group_plain, l2_cache_bytes,
        plan_groups)

    levels, width = tables.shape
    groups = plan_groups(levels, width, l2_cache_bytes(lo.device),
                         sorted_links)
    per_table = [(k, k + 1) for k in range(levels)]
    fns = {"kernel_ms": lambda: descend_groups(tables, lo, hi, groups),
           "one_pass_ms": lambda: jump_group_cuda(tables, lo, hi),
           "per_table_ms": lambda: descend_groups(tables, lo, hi, per_table),
           "plain_ms": lambda: jump_group_plain(tables, lo, hi)}
    want = fns["plain_ms"]()
    for name in ("kernel_ms", "one_pass_ms", "per_table_ms"):
        got = fns[name]()
        if not torch.equal(got, want):
            err = int((got.long() - want.long()).abs().max())
            raise AssertionError(f"K1 ({name[:-3]} order) disagrees with "
                                 f"its plain version: max_abs_err={err}")
    return {"groups": groups, **time_turns(fns, device),
            "bound_ms": k1_bound_ms(int(lo.shape[0]), levels, width)}


def k1_case(name: str, lo, hi, n: int, levels: int, device, timed: bool,
            f=None, sorted_links: bool = False):
    """K1 against fused_descend_plain on one input (f: the one-step table,
    the links' own min-up table if None): exact lo and moved."""
    from sheep_tpu_torch.ops.forest import min_up_table
    from sheep_tpu_torch.ops.fused_jump import (
        fused_descend, fused_descend_plain, lift_tables)

    e = int(lo.shape[0])
    if f is None:
        f = min_up_table(lo, hi, n)
    got_lo, got_moved = fused_descend(lo, hi, n, levels, f, sorted_links)
    want_lo, want_moved = fused_descend_plain(lo, hi, n, levels, f)
    err = int((got_lo.long() - want_lo.long()).abs().max()) if e else 0
    equal = torch.equal(got_lo, want_lo) and int(got_moved) == int(want_moved)
    rec = {"case": name, "n": n, "E": e, "L": levels,
           "sorted_links": sorted_links, "equal": equal,
           "max_abs_err": err, "moved": int(got_moved)}
    if timed and equal:
        rec.update(k1_orders(lift_tables(f, levels), lo, hi, device,
                             sorted_links))
    log("k1 " + json.dumps(rec))
    if not equal:
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


def k1_forced_groups(device: torch.device, n: int = 1 << 16,
                     levels: int = 7, e: int = 200_000):
    """Groupings forced on the card: a small ``l2_bytes`` makes the
    planner give g = 1, 2 and L tables a launch.  Each on aligned inputs,
    on views at storage offsets 1-3 (the kernel's scalar path) and at
    E % 4 = 1, 2, 3 (its tail), exactly equal to jump_group_plain, with
    one launch per group."""
    from sheep_tpu_torch.ops import fused_jump
    from sheep_tpu_torch.ops.forest import min_up_table

    width = n + 1
    base_lo, base_hi = k1_inputs(n, e + 8, 9, device)
    tables = fused_jump.lift_tables(min_up_table(base_lo, base_hi, n),
                                    levels)
    layouts = [("aligned", 0, e)] + [(f"offset{k}", k, e) for k in (1, 2, 3)] \
        + [(f"tail{k}", 0, e + k) for k in (1, 2, 3)]
    recs = []
    for g in (1, 2, levels):
        l2 = int(g * 4 * width / fused_jump.L2_TABLE_SHARE) + 64
        groups = fused_jump.plan_groups(levels, width, l2)
        if len(groups) != -(-levels // g):
            raise AssertionError(f"plan_groups at l2_bytes={l2} gave "
                                 f"{groups}, not groups of {g}")
        for layout, off, size in layouts:
            lo = base_lo[off:off + size]
            hi = base_hi[off:off + size]
            before = fused_jump.launches
            got = fused_jump.descend_groups(tables, lo, hi, groups)
            launched = fused_jump.launches - before
            want = fused_jump.jump_group_plain(tables, lo, hi)
            equal = torch.equal(got, want)
            rec = {"case": f"forced_g{g}_{layout}", "n": n, "E": size,
                   "L": levels, "groups": len(groups), "launches": launched,
                   "equal": equal,
                   "max_abs_err": int((got.long() - want.long()).abs().max())}
            log("k1 " + json.dumps(rec))
            if not equal or launched != len(groups):
                raise AssertionError(f"K1 forced grouping failed: {rec}")
            recs.append(rec)
    return recs


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
    recs.extend(k1_forced_groups(device))
    n = 1 << 20
    lo, hi = k1_inputs(n, ragged_e, 7, device)
    recs.append(k1_case("ragged", lo, hi, n, 10, device, timed=True))
    # random links at E = 2^26 and L = 4 over the n where one table goes
    # from a sixth of the L2 to two thirds of it
    for log_n in (real_log_n - 2, real_log_n - 1):
        n = 1 << log_n
        lo, hi = k1_inputs(n, 1 << real_log_e, 8, device)
        recs.append(k1_case(f"n{log_n}_L4", lo, hi, n, 4, device,
                            timed=True))
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
               bytes_moved: int, library=None, layout: str = "aligned",
               extra: dict | None = None):
    """One probe kernel against its plain version on one input: exactly
    equal, then kernel_ms, plain_ms, library_ms and any ``extra`` (name ->
    callable of the same args) timed in turns (:func:`time_turns`), and
    bound_ms (bytes over the card's memory rate)."""
    got = kernel(*args)
    want = plain(*args)
    equal = torch.equal(got, want)
    err = int((got.long() - want.long()).abs().max())
    fns = {"kernel_ms": lambda: kernel(*args),
           "plain_ms": lambda: plain(*args)}
    if library is not None:
        fns["library_ms"] = lambda: library(*args)
    for key, fn in (extra or {}).items():
        fns[key] = lambda fn=fn: fn(*args)
    rec = {"kernel": name, "n": n, "layout": layout, "equal": equal,
           "max_abs_err": err, "library_ms": None,
           **time_turns(fns, device),
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3}
    log("probe " + json.dumps(rec))
    if not equal:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{rec}")
    return rec


def p2_cases(device: torch.device, log_ns) -> list:
    """P2 against its plain version: the probe's inputs at each size (one
    torch.gather timed beside it), then at the largest size a ragged E
    (2^k + 3), views at storage offsets 1-3 (the scalar path), and lo
    drawn below 0 and at or past the table's width on the int4 path and
    the scalar path (the clamp), every case exactly equal."""
    from sheep_tpu_torch.ops import probe
    from sheep_tpu_torch.scripts import kernel_probe

    # a floor for any gather-based version: the gather alone
    extra = {"gather_only_ms": lambda f, lo, hi: torch.gather(f, 0, lo)}
    recs = []
    for log_n in log_ns:
        n = 1 << log_n
        args = kernel_probe.probe_inputs(n, device)
        recs.append(probe_case("jump_step", n, probe.jump_step,
                               probe.jump_step_plain, args, device, 16 * n,
                               extra=extra))
        del args
    n = 1 << max(log_ns)
    g = torch.Generator(device=device).manual_seed(4)
    f = kernel_probe.probe_inputs(n, device)[0]
    lo = torch.randint(0, n, (n + 8,), generator=g, device=device)
    hi = torch.clamp(lo + torch.randint(1, 1024, (n + 8,), generator=g,
                                        device=device), max=n)
    # lo below 0 and at or past the width, hi so that some still step
    wild = torch.randint(-37, n + 37, (n + 8,), generator=g, device=device)
    wild_hi = wild + torch.randint(-3, 1024, (n + 8,), generator=g,
                                   device=device)
    lo, hi, wild, wild_hi = (t.to(torch.int32) for t in (lo, hi, wild,
                                                         wild_hi))
    layouts = [("tail3", lo, hi, 0, n + 3)] \
        + [(f"offset{k}", lo, hi, k, n) for k in (1, 2, 3)] \
        + [("clamp_aligned", wild, wild_hi, 0, n),
           ("clamp_offset1", wild, wild_hi, 1, n + 1)]
    for layout, a, b, off, size in layouts:
        args = (f, a[off:off + size], b[off:off + size])
        recs.append(probe_case("jump_step", size, probe.jump_step,
                               probe.jump_step_plain, args, device,
                               16 * size, layout=layout))
    return recs


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
        del x
    # P1's scalar path at the largest size: n % 4 != 0, and views at
    # storage offsets 1-3 (not 16-byte aligned); INT32_MAX wraps
    n = 1 << max(log_ns)
    buf = torch.arange(n + 8, dtype=torch.int32, device=device)
    buf[:8] = torch.iinfo(torch.int32).max
    for layout, off, size in [("tail3", 0, n + 3)] + [
            (f"offset{k}", k, n) for k in (1, 2, 3)]:
        recs.append(probe_case("add_one", size, probe.add_one,
                               probe.add_one_plain, (buf[off:off + size],),
                               device, 8 * size, library=lambda a: a + 1,
                               layout=layout))
    del buf
    # P2 also at 2^22, where f (16 MB) fits the L2 with room to spare
    recs.extend(p2_cases(device, tuple(sorted(set(log_ns) | {22}))))
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


#: the speculative arm: stream off, the overlap at its CUDA default (on)
SPEC_ARM = {"SHEEP_STREAM_HANDOFF": "0", "SHEEP_OVERLAP_HANDOFF": None}


@contextlib.contextmanager
def env_set(values: dict):
    """Set the given variables (None unsets one) inside the block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class K1Recorder:
    """Records every K1 call of one build, with no knob in the package: it
    wraps the descent seam ``ops.forest._lift_descend`` and the launcher
    ``ops.fused_jump.jump_group_cuda`` while it is entered.  Per descent:
    the table width, E, L, whether the links came sorted, the launches it
    made (one per table group) and their device time (CUDA events around
    each launch); and a copy of the first chunk round's input (the second
    descent: the first is the jump-only opener), moved to host memory when
    the recorder exits."""

    keep_call = 1

    def __init__(self):
        self.calls: list = []
        self.events: list = []
        self.kept: dict | None = None

    def __enter__(self):
        from sheep_tpu_torch.ops import forest, fused_jump

        self._saved = (forest._lift_descend, fused_jump.jump_group_cuda)
        descend, launch = self._saved

        def recorded_launch(tables, lo, hi, out=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = launch(tables, lo, hi, out=out)
            end.record()
            self.events.append((start, end))
            return got

        def recorded_descend(lo, hi, n, levels, f, sorted_links=False):
            if len(self.calls) == self.keep_call:
                self.kept = {"lo": lo.to(torch.int32).contiguous().clone(),
                             "hi": hi.to(torch.int32).contiguous().clone(),
                             "f": f.to(torch.int32).clone(), "n": n,
                             "levels": levels, "sorted_links": sorted_links}
            before = fused_jump.launches
            got = descend(lo, hi, n, levels, f, sorted_links)
            self.calls.append({"width": int(f.shape[0]),
                               "E": int(lo.shape[0]), "L": max(1, levels),
                               "sorted_links": sorted_links,
                               "groups": fused_jump.launches - before})
            return got

        forest._lift_descend = recorded_descend
        fused_jump.jump_group_cuda = recorded_launch
        return self

    def __exit__(self, *exc):
        from sheep_tpu_torch.ops import forest, fused_jump

        forest._lift_descend, fused_jump.jump_group_cuda = self._saved
        if self.kept is not None:
            # host memory from here on, so the later builds' peak device
            # memory does not count it
            self.kept = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in self.kept.items()}
        return False

    def device_ms(self) -> float:
        """K1's summed device time over the recorded launches; each call's
        own goes into its record as ``ms``."""
        if self.events:
            self.events[-1][1].synchronize()
        times = [a.elapsed_time(b) for a, b in self.events]
        first = 0
        for call in self.calls:
            call["ms"] = sum(times[first:first + call["groups"]])
            first += call["groups"]
        return sum(times)


def real_inputs(log_n: int, log_e: int, seed: int):
    """rmat_edges(log_n, 2^log_e, seed) and its host oracle."""
    from sheep_tpu_torch.utils import rmat_edges

    t0 = time.perf_counter()
    tail, head = rmat_edges(log_n, 1 << log_e, seed=seed)
    log(f"real: rmat_edges({log_n}, 2^{log_e}, seed={seed}) in "
        f"{time.perf_counter() - t0:.2f}s")
    want_seq, want, oracle_s = oracle(tail, head)
    log(f"real: host oracle in {oracle_s:.2f}s, m={len(want_seq)}")
    return tail, head, want_seq, want


def real_size_phase(device: torch.device, log_n: int = 23,
                    log_e: int = 26, runs: int = 2, windows: int = 4,
                    data=None):
    """The real-size hybrid on every arm: the default streamed tail first
    and third, the serial arm second, the speculative arm fourth; returns
    the runs' records and the first run's K1 recorder.  ``data``: the
    (tail, head, want_seq, want) of :func:`real_inputs`, made here if
    None."""
    from sheep_tpu_torch.ops.build import build_graph_hybrid

    tail, head, want_seq, want = data if data is not None \
        else real_inputs(log_n, log_e, 0)
    recs = []
    recorder = K1Recorder()
    # the default tail (streamed) runs first and third, the serial arm
    # between, so the two arms meet on one card in turns; then the
    # speculative arm
    arms = ["stream"] * (runs - 1) + ["serial", "stream", "spec"]
    envs = {"stream": {}, "serial": SERIAL_ARM, "spec": SPEC_ARM}
    for run, arm in enumerate(arms):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        perf: dict = {}
        with env_set(envs[arm]), \
                (recorder if run == 0 else contextlib.nullcontext()):
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
        if run == 0:
            rec["k1_device_ms"] = recorder.device_ms()
            rec["k1_calls"] = recorder.calls
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
        if arm == "spec" and ("spec_mode" not in perf
                              or "spec_starts" not in perf
                              or "stream_mode" in perf):
            raise AssertionError(f"real-size hybrid: the speculative arm "
                                 f"did not run: {perf}")
        recs.append(rec)
    if recorder.kept is None:
        raise AssertionError(f"real-size hybrid: no chunk round reached K1 "
                             f"({recorder.calls})")
    return recs, recorder


@contextlib.contextmanager
def spec_forced(outcome: str):
    """Force one outcome of the speculative handoff without a knob in the
    package, through its seams.  "spec_complete": at each chunk after its
    start the stream is joined (left to land) before the policy looks, so
    the loop stops on a finished stream.  "spec_wait": each stream holds
    its last slice until a caller joins it, and at each chunk and at the
    loop's end the policy looks only once the stream has fetched the
    rest, so the loop ends with the stream one slice short and
    ``complete`` waits it out.  Either way the stream's slices copy on the
    side stream while the loop's next chunk runs."""
    from sheep_tpu_torch.ops import build

    saved = (build._StreamFetcher, build._SpecHandoff.on_chunk,
             build._SpecHandoff.complete)
    on_chunk, complete = saved[1], saved[2]

    class LastSliceHeld(saved[0]):
        def __init__(self, *args, **kwargs):
            self._gate = threading.Event()
            self.at_gate = threading.Event()
            super().__init__(*args, **kwargs)

        def _wait_turn(self, i):
            if i == self.total_slices - 1:
                self.at_gate.set()
                self._gate.wait(timeout=300)

        def join(self, timeout=None, mark_failed=True):
            self._gate.set()
            return super().join(timeout, mark_failed)

    def settle(spec):
        if spec.active is None:
            return
        if outcome == "spec_complete":
            spec.active.join(timeout=300)
        else:
            spec.active.at_gate.wait(timeout=300)

    def settled_chunk(self, lo, hi, live):
        settle(self)
        return on_chunk(self, lo, hi, live)

    def settled_complete(self, lo, hi, live):
        settle(self)
        return complete(self, lo, hi, live)

    if outcome not in ("spec_complete", "spec_wait"):
        raise ValueError(f"spec_forced: no outcome {outcome!r}")
    if outcome == "spec_wait":
        build._StreamFetcher = LastSliceHeld
    build._SpecHandoff.on_chunk = settled_chunk
    build._SpecHandoff.complete = settled_complete
    try:
        yield
    finally:
        (build._StreamFetcher, build._SpecHandoff.on_chunk,
         build._SpecHandoff.complete) = saved


def spec_outcomes_phase(device: torch.device, log_n: int = 18,
                        log_e: int = 21, seed: int = 2):
    """The speculative arm handing off a snapshot that its stream fetched
    on the side stream: spec_complete (the stream stops the loop) and
    spec_wait, each 6-byte packed and in int32 pairs (where the stream
    reads the loop's own lo and hi), on rmat_edges(18, 2^21, seed=2);
    each forest equal to the oracle, K1 launched.  Small knobs make a
    stream start at this size (SHEEP_OVERLAP_MIN_MB=0.01, 16K-link
    slices, SHEEP_OVERLAP_SPEC_FACTOR=64), and the handoff factor is the
    card's default, 3, so a chunk follows the stream's start."""
    from sheep_tpu_torch.ops.build import build_graph_hybrid

    tail, head, want_seq, want = real_inputs(log_n, log_e, seed)
    knobs = {**SPEC_ARM, "SHEEP_OVERLAP_MIN_MB": "0.01",
             "SHEEP_OVERLAP_SLICE": str(1 << 14),
             "SHEEP_OVERLAP_SPEC_FACTOR": "64",
             "SHEEP_HANDOFF_FACTOR": "3"}
    recs = []
    for outcome in ("spec_complete", "spec_wait"):
        for packed in (True, False):
            perf: dict = {}
            env = {**knobs, "SHEEP_PACK_HANDOFF": None if packed else "0"}
            with env_set(env), spec_forced(outcome):
                (seq, forest), wall, launches = counted_build(
                    lambda: build_graph_hybrid(tail, head, device=device,
                                               perf=perf),
                    f"spec arm ({outcome})")
            rec = {"outcome": outcome, "records": len(tail), "wall_s": wall,
                   "k1_launches": launches, **perf}
            log("spec outcome " + json.dumps(rec))
            if not forest_equal(seq, forest, want_seq, want):
                raise AssertionError(f"spec arm ({outcome}, packed="
                                     f"{packed}) differs from the oracle")
            stopped = outcome == "spec_complete"
            if (perf.get("spec_mode") != outcome
                    or perf.get("packed_handoff") is not packed
                    or perf.get("spec_stopped_loop") is not stopped):
                raise AssertionError(f"spec arm: wanted {outcome} with "
                                     f"packed={packed}, got {perf}")
            recs.append(rec)
    return recs


def fetch_phase(device: torch.device, n: int = 1 << 23, links: int = 1 << 24,
                slices=(1 << 18, 1 << 21)):
    """The speculative arm's fetch thread (``ops.build._StreamFetcher``)
    alone on the card, nothing else running: a snapshot of 2^24 random
    links at n = 2^23 (6-byte packed, 100 MB) fetched in slices of 2^18
    links (the default) and 2^21, its host copy equal to the snapshot.
    Logs the thread's breakdown (``ops.build.fetch_phases``: pinned
    allocation, copy enqueue and event wait on the host, the copies'
    device time) and its rate."""
    from sheep_tpu_torch.ops.build import _StreamFetcher

    g = torch.Generator(device=device).manual_seed(5)
    lo = torch.randint(0, n, (links,), generator=g, device=device)
    hi = torch.clamp(lo + torch.randint(1, 1024, (links,), generator=g,
                                        device=device), max=n)
    lo, hi = lo.to(torch.int32), hi.to(torch.int32)
    want_lo, want_hi = lo.cpu().numpy(), hi.cpu().numpy()
    recs = []
    for slice_links in slices:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = _StreamFetcher(lo, hi, n, links, slice_links)
        if f.join(timeout=600) or f.failed:
            raise AssertionError(f"fetch: the stream did not finish "
                                 f"({f.error!r})")
        wall = time.perf_counter() - t0
        got_lo, got_hi = f.collect()
        if not (np.array_equal(got_lo[:links], want_lo)
                and np.array_equal(got_hi[:links], want_hi)):
            raise AssertionError("fetch: the host copy differs from the "
                                 "snapshot")
        rec = {"slice_links": slice_links, "packed": f.packed,
               "wall_s": wall, **f.phases,
               "gb_per_s": f.phases["bytes"] / wall / 1e9}
        log("fetch " + json.dumps(rec))
        recs.append(rec)
        del f, got_lo, got_hi
    return recs


def _blocks(tail, head, block: int):
    for a in range(0, len(tail), block):
        yield tail[a:a + block], head[a:a + block]


def streaming_run(name: str, hosted: bool, tail, head, want_seq, want,
                  block: int, device: torch.device, golden: bool = False):
    """One streaming build over the records in blocks of ``block``: the
    forest over the sequence's m positions, equal to the oracle's, K1
    launched; with ``golden`` its TREEFAQS line must be the golden one."""
    from sheep_tpu_torch.core import compute_facts
    from sheep_tpu_torch.core.sequence import sequence_positions
    from sheep_tpu_torch.ops.stream import (build_graph_streaming,
                                            build_graph_streaming_hosted)

    m = len(want_seq)
    pos = sequence_positions(want_seq, int(max(tail.max(), head.max())))
    perf: dict = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if hosted:
        def build():
            return build_graph_streaming_hosted(_blocks(tail, head, block),
                                                m, pos, block, device=device,
                                                perf=perf)
    else:
        def build():
            return build_graph_streaming(_blocks(tail, head, block), m, pos,
                                         block, device=device)
    (forest, rounds), wall, launches = counted_build(build, name)
    if not (np.array_equal(forest.parent, want.parent)
            and np.array_equal(forest.pst_weight, want.pst_weight)):
        raise AssertionError(f"{name} differs from the oracle")
    rec = {"case": name, "hosted": hosted, "records": len(tail),
           "block": block, "blocks": -(-len(tail) // block),
           "wall_s": wall, "records_per_s": len(tail) / wall,
           "k1_launches": launches, **perf,
           # every block's rounds and the final fold's (perf's "rounds"
           # and loop_s are the final fold's alone)
           "total_rounds": rounds}
    if device.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if golden:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            compute_facts(forest).print()
        text = buf.getvalue()
        log(f"{name}: {text.strip()}".replace("\n", " /"))
        if text != GOLDEN_TREEFAQS:
            raise AssertionError(f"{name}: TREEFAQS differs from the golden "
                                 f"line:\n{text}")
    log("streaming " + json.dumps(rec))
    return rec


def streaming_phase(device: torch.device, real, small, hep_block: int = 4096,
                    real_block: int = 1 << 24, small_blocks: int = 4):
    """The out-of-core builds: the hosted build on the real-size graph in
    blocks of 2^24 records (sheep_tpu/cli/degree_sequence.py's block),
    the fixpoint build on ``small`` in four blocks, and both on hep-th
    with the golden TREEFAQS line; every forest equal to the oracle."""
    from sheep_tpu_torch.core import build_forest, degree_sequence
    from sheep_tpu_torch.io import load_edges

    el = load_edges(os.path.join(ROOT, "data", "hep-th.dat"))
    hep_seq = degree_sequence(el.tail, el.head)
    hep = (el.tail, el.head, hep_seq, build_forest(el.tail, el.head,
                                                   hep_seq))
    recs = [streaming_run("hep-th streaming hosted", True, *hep, hep_block,
                          device, golden=True),
            streaming_run("hep-th streaming", False, *hep, hep_block,
                          device, golden=True)]
    block = -(-len(small[0]) // small_blocks)
    recs.append(streaming_run("streaming (fixpoint)", False, *small, block,
                              device))
    recs.append(streaming_run("real-size streaming hosted", True, *real,
                              real_block, device))
    return recs


def device_phase(device: torch.device, data=None, log_n: int = 20,
                 log_e: int = 23):
    """build_graph_device on ``data`` (:func:`real_inputs` of
    rmat_edges(20, 2^23, seed=1) if None), equal to the oracle."""
    from sheep_tpu_torch.ops.build import build_graph_device

    tail, head, want_seq, want = data if data is not None \
        else real_inputs(log_n, log_e, 1)
    (seq, forest), wall, launches = counted_build(
        lambda: build_graph_device(tail, head, device=device),
        "full device build")
    if not forest_equal(seq, forest, want_seq, want):
        raise AssertionError("full device build differs from the oracle")
    rec = {"records": len(tail), "wall_s": wall, "k1_launches": launches}
    log("device build " + json.dumps(rec))
    return rec



def omp_runtimes() -> list:
    """The OpenMP runtimes mapped into this process (/proc/self/maps):
    torch's wheel ships its own libgomp beside the one g++ links."""
    found = set()
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1] if len(line.split()) >= 6 else ""
            if re.search(r"lib(g|i)?omp[^/]*\.so", os.path.basename(path)):
                found.add(path)
    return sorted(found)


def numpy_degree_sequence(tail, head, n=None):
    """The port's degree order before the native sort: a numpy
    histogram, then a stable argsort of the degrees over the active
    vids (core/sequence.py as it stood before the native runtime)."""
    if n is None:
        n = int(max(tail.max(), head.max())) + 1
    deg = np.bincount(tail, minlength=n) + np.bincount(head, minlength=n)
    vids = np.nonzero(deg)[0]
    return vids[np.argsort(deg[vids], kind="stable")].astype(np.uint32)


@contextlib.contextmanager
def attr_set(obj, name: str, value):
    """Replace ``obj.name`` inside the block (None keeps it)."""
    old = getattr(obj, name)
    if value is not None:
        setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def native_phase(device: torch.device, data):
    """The native host runtime on the real-size graph: the numpy degree
    order against the fused native sort; the blocked fused build against
    edges_to_links + the plain fold; the links fold on 1 thread and on
    the host's granted cores; then the hybrid with the numpy order forced
    into its prefetch and with the native one.  Every pair equal, each
    side timed (host seconds)."""
    from sheep_tpu_torch import native
    from sheep_tpu_torch.core import sequence as seqmod
    from sheep_tpu_torch.ops.build import build_graph_hybrid

    tail, head, want_seq, want = data
    cores = len(os.sched_getaffinity(0))
    rec = {"records": len(tail), "host_cores": cores,
           "omp_compiled": native.omp_compiled(),
           "omp_max_threads": native.omp_max_threads(),
           "omp_runtimes": omp_runtimes()}
    n = int(max(tail.max(), head.max())) + 1
    want_pair = (want.parent, want.pst_weight)

    def equal(got, what):
        if not all(np.array_equal(a, b) for a, b in zip(got, want_pair)):
            raise AssertionError(f"native: {what} differs from the oracle")

    with env_set({"SHEEP_NATIVE_THREADS": None,
                  "SHEEP_NATIVE_BLOCKED": None}):
        seq_np, rec["seq_numpy_s"] = timed_call(
            lambda: numpy_degree_sequence(tail, head, n))
        seq_nat, rec["seq_native_s"] = timed_call(
            lambda: native.degree_sequence_from_edges(tail, head, n))
        if not (np.array_equal(seq_np, want_seq)
                and np.array_equal(seq_nat, want_seq)):
            raise AssertionError("native: the degree orders differ")
        del seq_np, seq_nat
        pos = seqmod.sequence_positions(want_seq, n - 1)
        m = len(want_seq)
        got, rec["forest_blocked_s"] = timed_call(
            lambda: native.build_forest_edges(tail, head, pos, m))
        equal(got, "the blocked fused build")
        with env_set({"SHEEP_NATIVE_BLOCKED": "0"}):
            (lo, hi), rec["edges_to_links_s"] = timed_call(
                lambda: native.edges_to_links(tail, head, pos))
            got, rec["fold_plain_s"] = timed_call(
                lambda: native.build_forest_links(lo, hi, m))
            equal(got, "edges_to_links + the plain fold")
        rec["links"] = len(lo)
        got, rec["fold_1_thread_s"] = timed_call(
            lambda: native.build_forest_links(lo, hi, m))
        equal(got, "the fold on 1 thread")
        rec["fold_1_thread_used"] = native.last_thread_stats()[0]
    with env_set({"SHEEP_NATIVE_THREADS": str(cores)}):
        got, rec["fold_threaded_s"] = timed_call(
            lambda: native.build_forest_links(lo, hi, m))
        equal(got, f"the fold on {cores} threads")
        used, busy = native.last_thread_stats()
        rec["fold_threaded_used"] = used
        rec["fold_thread_busy_s"] = busy
        got, rec["forest_blocked_threaded_s"] = timed_call(
            lambda: native.build_forest_edges(tail, head, pos, m))
        equal(got, f"the blocked fused build on {cores} threads")
    del lo, hi, pos, got
    if native.omp_compiled() and cores > 1 and used != cores:
        raise AssertionError(f"native: the threaded fold ran on {used} "
                             f"threads, not the host's {cores}")
    if rec["fold_1_thread_used"] != 1:
        raise AssertionError("native: the unthreaded fold used threads")
    keys = ("prefetch_s", "prefetch_seq_s", "prefetch_pst_s", "pst_wait_s",
            "fold_s", "loop_s", "stream_mode")
    for arm, order in (("numpy_order", numpy_degree_sequence),
                       ("native_order", None)):
        perf: dict = {}
        with attr_set(seqmod, "degree_sequence", order):
            # host_edges as the card's default sets it: the prefetch
            # recomputes seq and pst from the host records
            (seq, forest), wall, launches = counted_build(
                lambda: build_graph_hybrid(tail, head, device=device,
                                           host_edges=(tail, head),
                                           perf=perf),
                f"native: hybrid ({arm})")
        if not forest_equal(seq, forest, want_seq, want):
            raise AssertionError(f"native: hybrid ({arm}) differs from the "
                                 f"oracle")
        if "prefetch_seq_s" not in perf:
            raise AssertionError(f"native: hybrid ({arm}) recorded no "
                                 f"prefetch split: {perf}")
        rec[arm] = {"wall_s": wall, "k1_launches": launches,
                    **{k: perf.get(k) for k in keys}}
    log("native " + json.dumps(rec))
    return rec


#: the 2-part hep-th report of the reference's published run
HEP_BIPARTITION = {"edges_cut": 2811, "vcom_vol": 2061, "ecv_hash": 1311,
                   "ecv_down": 521, "ecv_up": 1539}


def partition_phase(device: torch.device, real, small,
                    real_parts=(2, 16, 64), eval_parts=(2, 64),
                    block: int = 1 << 24):
    """Partitions of trees built on the card: hep-th by the hybrid
    (K1 counted) at 2-9 parts against data/hepth-ecv-baseline.json and
    the golden 2-part report; four partial hep-th forests built on the
    card over one sequence, merged to the whole tree; the native forward
    pass against the python one on ``small``; the real-size tree at
    ``real_parts`` parts, and at ``eval_parts`` of them the in-memory
    evaluator against the streamed one, each timed."""
    from sheep_tpu_torch.core import (build_forest, degree_sequence,
                                      merge_forests, sequence_positions)
    from sheep_tpu_torch.io import load_edges, read_dat
    from sheep_tpu_torch.ops.build import build_graph_hybrid
    from sheep_tpu_torch.partition import (Partition, evaluate_partition,
                                           partition_forest)
    from sheep_tpu_torch.partition.evaluate import \
        evaluate_partition_streamed

    hep = os.path.join(ROOT, "data", "hep-th.dat")
    with open(os.path.join(ROOT, "data", "hepth-ecv-baseline.json")) as f:
        baseline = {int(k): v for k, v in json.load(f)["ecv_down"].items()}
    el = load_edges(hep)
    want_seq = degree_sequence(el.tail, el.head)
    want = build_forest(el.tail, el.head, want_seq)
    (seq, forest), wall, launches = counted_build(
        lambda: build_graph_hybrid(el.tail, el.head, device=device),
        "partition: hep-th hybrid")
    if not forest_equal(seq, forest, want_seq, want):
        raise AssertionError("partition: hep-th hybrid differs from the "
                             "oracle")
    rec = {"hep_k1_launches": launches, "hep_build_s": wall}
    ecv = {}
    for p in sorted(baseline):
        part = Partition.from_forest(seq, forest, p, max_vid=el.max_vid)
        rep = evaluate_partition(part.parts, el.tail, el.head, seq, p,
                                 max_vid=el.max_vid,
                                 file_edges=el.num_edges)
        ecv[p] = rep.ecv_down
        if p == 2:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                part.print()
                rep.print()
            log("partition hep-th 2 parts: "
                + buf.getvalue().strip().replace("\n", " / "))
            sizes = [int((part.parts == 0).sum()),
                     int((part.parts == 1).sum())]
            got = {k: getattr(rep, k) for k in HEP_BIPARTITION}
            if got != HEP_BIPARTITION or sizes != [3409, 4201]:
                raise AssertionError(f"partition: hep-th 2-part report "
                                     f"{got}, sizes {sizes}")
    rec["hep_ecv_down"] = ecv
    if ecv != baseline:
        raise AssertionError(f"partition: hep-th ECV(down) {ecv} != the "
                             f"baseline {baseline}")
    partials, rec["partial_k1_launches"] = [], []
    for k in range(1, 5):
        piece = read_dat(hep, k, 4)
        # handoff factor 0: the loop reduces each slice to convergence
        (pseq, pforest), _, plaunch = counted_build(
            lambda: build_graph_hybrid(piece.tail, piece.head,
                                       num_vertices=el.max_vid + 1,
                                       seq=seq, handoff_factor=0,
                                       device=device),
            f"partition: hep-th slice {k}/4")
        if not np.array_equal(pseq, seq):
            raise AssertionError("partition: a slice changed the sequence")
        partials.append(pforest)
        rec["partial_k1_launches"].append(plaunch)
    merged = merge_forests(*partials)
    if not forest_equal(seq, merged, want_seq, want):
        raise AssertionError("partition: the merged hep-th slices differ "
                             "from the whole tree")
    stail, shead, sseq, sforest = small
    rec["forward_small"] = []
    for p in real_parts:
        nat, nat_s = timed_call(lambda: partition_forest(sforest, p))
        py, py_s = timed_call(
            lambda: partition_forest(sforest, p, impl="python"))
        if not np.array_equal(nat, py):
            raise AssertionError(f"partition: native and python forward "
                                 f"passes differ at {p} parts")
        rec["forward_small"].append({"parts": p, "native_s": nat_s,
                                     "python_s": py_s})
    tail, head, rseq, rforest = real
    mv = int(max(tail.max(), head.max()))
    pos = sequence_positions(rseq, mv)
    rec["real"] = []
    for p in real_parts:
        part, part_s = timed_call(
            lambda: Partition.from_forest(rseq, rforest, p, max_vid=mv))
        if p not in eval_parts:
            rec["real"].append({"parts": p, "partition_s": part_s,
                                "created": part.max_part + 1})
            continue
        dense, dense_s = timed_call(
            lambda: evaluate_partition(part.parts, tail, head, rseq, p,
                                       max_vid=mv, file_edges=len(tail)))
        stream, stream_s = timed_call(
            lambda: evaluate_partition_streamed(
                part.parts, lambda: _blocks(tail, head, block), pos, p,
                len(tail)))
        if vars(dense) != vars(stream):
            raise AssertionError(f"partition: the evaluators differ at {p} "
                                 f"parts: {vars(dense)} vs {vars(stream)}")
        rec["real"].append({"parts": p, "partition_s": part_s,
                            "evaluate_s": dense_s,
                            "evaluate_streamed_s": stream_s,
                            "created": part.max_part + 1,
                            "ecv_down": dense.ecv_down,
                            "edges_cut": dense.edges_cut})
    log("partition " + json.dumps(rec))
    return rec

HEP_PARTITION_LINES = ("Actually created 2 partitions.",
                       "First two partition sizes: 3409 and 4201",
                       "edges cut: 2811 ", "ECV(down): 521 ")


def run_tool(tool: str, argv: list, env: dict | None = None,
             count_k1: bool = False, timeout: int = 600):
    """One CLI tool as a process of its own, ``python -m
    sheep_tpu_torch.cli.<tool>``, from the checkout's root; returns
    (stdout, wall s, K1 launches or None).  ``count_k1`` runs the tool's
    ``main`` through ``python -c`` instead and has the process print K1's
    launch count on stderr after it, so a run on the card can be counted
    from outside."""
    if count_k1:
        prog = ("import sys\n"
                f"from sheep_tpu_torch.cli import {tool} as tool\n"
                "from sheep_tpu_torch.ops import fused_jump\n"
                "rc = tool.main(sys.argv[1:])\n"
                "print('k1_launches', fused_jump.launches, file=sys.stderr)\n"
                "sys.exit(rc)\n")
        cmd = [sys.executable, "-c", prog] + argv
    else:
        cmd = [sys.executable, "-m", f"sheep_tpu_torch.cli.{tool}"] + argv
    full_env = dict(os.environ)
    full_env.update(env or {})
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=full_env, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli: {tool} {' '.join(argv)} exited "
                             f"{proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    launches = None
    if count_k1:
        found = re.findall(r"^k1_launches (\d+)$", proc.stderr, re.M)
        launches = int(found[-1])
    return proc.stdout, wall, launches


def run_main(module, argv: list, **kw):
    """A tool's ``main`` in this process, stdout captured; returns
    (stdout, wall s, K1 launches), every count set to 0 just before."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli: {module.__name__} {argv} returned {rc}")
    return buf.getvalue(), wall, read_counts()["fused_jump"]


def same_files(*paths) -> bool:
    """Equal bytes, and equal sidecars where the first has one."""
    def read(p):
        with open(p, "rb") as f:
            return f.read()
    first = read(paths[0])
    ok = all(read(p) == first for p in paths[1:])
    if os.path.exists(paths[0] + ".sum"):
        ok = ok and all(read(p + ".sum") == read(paths[0] + ".sum")
                        for p in paths[1:])
    return ok


def cli_phase(device: torch.device, real, part_rec: dict, log_n: int = 23,
              factor: int = 8):
    """The port's CLI, the user's entry point: hep-th through ``graph2tree
    -i -r`` on the card in process (K1 counted, the golden TREEFAQS line)
    and as a process of its own; ``-r -s``, the serial tool and
    ``merge_trees`` over two record slices, the ``-i`` map route and the
    checkpointed build, each the same bytes; ``partition_tree`` at 2
    parts.  Then the real size in a temporary directory: ``make_graph 23
    8 G.dat 0`` (``log_n``, ``factor``), its load timed strict against
    trust, ``degree_sequence``, ``graph2tree -i -r -s`` (K1 counted in its
    process), equal to the oracle of ``real`` bit for bit, and
    ``partition_tree`` in memory and streamed, against ``part_rec`` (the
    partition phase's record)."""
    import shutil
    import tempfile

    from sheep_tpu_torch.cli import (degree_sequence, graph2tree,
                                     merge_trees, partition_tree)
    from sheep_tpu_torch.integrity import read_sidecar
    from sheep_tpu_torch.io import read_dat, read_sequence, read_tree

    hep = os.path.join(ROOT, "data", "hep-th.dat")
    rec: dict = {"hep": {}, "real": {}}
    checks: dict = {}
    tmp = tempfile.mkdtemp(prefix="sheep-cli.")
    try:
        t = lambda name: os.path.join(tmp, name)
        out, wall, k1 = run_main(graph2tree, [hep, "-i", "-r", "-f", "-c",
                                              "-o", t("ir.tre")],
                                 device=device)
        checks["hep_ir_golden"] = GOLDEN_TREEFAQS in out
        checks["hep_ir_valid"] = "Tree is valid." in out
        checks["hep_ir_k1"] = k1 > 0
        rec["hep"]["ir"] = {"wall_s": wall, "k1_launches": k1}
        out, wall, _ = run_tool("graph2tree", [hep, "-i", "-r", "-f", "-c",
                                               "-o", t("ir_proc.tre")])
        checks["hep_ir_process_golden"] = (GOLDEN_TREEFAQS in out
                                           and "Tree is valid." in out)
        checks["hep_ir_process_bytes"] = same_files(t("ir.tre"),
                                                    t("ir_proc.tre"))
        rec["hep"]["ir_process_wall_s"] = wall
        run_main(degree_sequence, [hep, t("s.seq")])
        run_main(graph2tree, [hep, "-s", t("s.seq"), "-o", t("serial.tre")])
        _, wall, k1 = run_main(graph2tree, [hep, "-r", "-s", t("s.seq"),
                                            "-o", t("r.tre")], device=device)
        rec["hep"]["r"] = {"wall_s": wall, "k1_launches": k1}
        for k in (1, 2):
            run_main(graph2tree, [hep, "-l", f"{k}/2", "-s", t("s.seq"),
                                  "-o", t(f"p{k}.tre")])
        run_main(merge_trees, [t("p1.tre"), t("p2.tre"), "-o",
                               t("merged.tre")])
        checks["hep_r_serial_merged"] = same_files(
            t("r.tre"), t("serial.tre"), t("merged.tre"), t("ir.tre"))
        _, wall, k1 = run_main(graph2tree, [hep, "-i", "-s", t("i.seq"),
                                            "-o", t("P")], device=device)
        rec["hep"]["i_map"] = {"wall_s": wall, "k1_launches": k1}
        checks["hep_i_map"] = (same_files(t("P00r0.tre"), t("ir.tre"))
                               and same_files(t("i.seq"), t("s.seq")))
        _, wall, k1 = run_main(graph2tree, [hep, "-i", "-r",
                                            "--checkpoint-dir", t("ck"),
                                            "-o", t("ck.tre")],
                               device=device)
        rec["hep"]["checkpoint"] = {"wall_s": wall, "k1_launches": k1}
        checks["hep_checkpoint"] = same_files(t("ck.tre"), t("ir.tre"))
        out, _, _ = run_main(partition_tree, ["-f", "-g", hep, t("s.seq"),
                                              t("ir.tre"), "2"])
        checks["hep_partition"] = all(ln in out
                                      for ln in HEP_PARTITION_LINES)
        if not all(checks.values()):
            raise AssertionError(f"cli: hep-th checks failed: {checks}")
        shutil.rmtree(tmp)
        tmp = tempfile.mkdtemp(prefix="sheep-cli-real.")

        tail, head, want_seq, want = real
        out, rec["real"]["make_graph_s"], _ = run_tool(
            "make_graph", [str(log_n), str(factor), t("G.dat"), "0"])
        # the strict load (the default: the sidecar's crc over the whole
        # file) against trust (no sidecar read), in turns
        loads = {"strict": [], "trust": []}
        for policy in ("strict", "trust", "trust", "strict"):
            el, load_s = timed_call(lambda: read_dat(t("G.dat"),
                                                     integrity=policy))
            loads[policy].append(load_s)
            if "real_make_graph_is_real_inputs" not in checks:
                checks["real_make_graph_is_real_inputs"] = (
                    np.array_equal(el.tail, tail)
                    and np.array_equal(el.head, head))
            del el
        rec["real"]["load_strict_s"] = loads["strict"]
        rec["real"]["load_trust_s"] = loads["trust"]
        rec["real"]["sidecar_algo"] = read_sidecar(t("G.dat"))["algo"]
        _, rec["real"]["degree_sequence_s"], _ = run_tool(
            "degree_sequence", [t("G.dat"), t("S.seq")])
        out, wall, k1 = run_tool(
            "graph2tree", [t("G.dat"), "-i", "-r", "-s", t("S2.seq"), "-o",
                           t("T.tre")], count_k1=True)
        rec["real"]["graph2tree_ir_s"] = wall
        rec["real"]["graph2tree_k1_launches"] = k1
        rec["real"]["graph2tree_phases"] = [
            ln for ln in out.splitlines() if " in: " in ln]
        checks["real_ir_k1"] = k1 > 0
        checks["real_seq_tools_agree"] = same_files(t("S.seq"), t("S2.seq"))
        parent, pst = read_tree(t("T.tre"))
        checks["real_tree_equals_oracle"] = (
            np.array_equal(read_sequence(t("S.seq")), want_seq)
            and np.array_equal(parent, want.parent)
            and np.array_equal(pst, want.pst_weight))
        del parent, pst
        out, rec["real"]["partition_tree_s"], _ = run_tool(
            "partition_tree", [t("S.seq"), t("T.tre"), "2", "16", "64"])
        created = [int(x) for x in
                   re.findall(r"^Actually created (\d+) partitions\.$",
                              out, re.M)]
        want_created = [r["created"] for r in part_rec["real"]]
        checks["real_partition_print"] = created == want_created
        out, rec["real"]["partition_tree_streamed_s"], _ = run_tool(
            "partition_tree", ["-g", t("G.dat"), t("S.seq"), t("T.tre"),
                               "2"], env={"SHEEP_EVAL_STREAM": "1"})
        ecv = [int(x) for x in re.findall(r"^ECV\(down\): (\d+) ", out,
                                          re.M)]
        want_ecv = next(r["ecv_down"] for r in part_rec["real"]
                        if r["parts"] == 2)
        rec["real"]["ecv_down_2"] = ecv
        checks["real_streamed_ecv_down_2"] = ecv == [want_ecv]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["checks"] = checks
    log("cli " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"cli: checks failed: {checks}")
    return rec


class SaveRecorder:
    """Times every checkpoint save of the fault-tolerant build and reads
    the snapshot's size on disk, with no knob in the package: it wraps
    ``runtime.snapshot.Checkpointer.save`` while entered."""

    def __init__(self):
        self.saves: list = []

    def __enter__(self):
        from sheep_tpu_torch.runtime import snapshot

        self._saved = snapshot.Checkpointer.save
        save = self._saved

        def timed_save(ck, snap):
            t0 = time.perf_counter()
            save(ck, snap)
            self.saves.append({"boundary": snap.boundary, "rung": snap.rung,
                               "links": int(len(snap.lo)),
                               "bytes": os.path.getsize(ck.path),
                               "s": time.perf_counter() - t0})

        snapshot.Checkpointer.save = timed_save
        return self

    def __exit__(self, *exc):
        from sheep_tpu_torch.runtime import snapshot

        snapshot.Checkpointer.save = self._saved
        return False


class LoopRecorder:
    """Splits the single rung's time with no knob in the package: it wraps,
    while entered, the dispatch sync (``runtime.retry.sync_outputs``: the
    wait for each dispatch's device work), the boundary fetch
    (``ops.forest._live_links_np``: the live links to the host), the
    plateau's host assist (``ops.forest._PlateauSched.assist``) and the
    vertex remap (``ops.forest.vremap_compact``), summing each one's
    host-clock seconds and calls."""

    def __init__(self):
        self.parts = {name: [0, 0.0] for name in
                      ("sync", "boundary_fetch", "assist", "remap")}

    def _timed(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                part = self.parts[name]
                part[0] += 1
                part[1] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        from sheep_tpu_torch.ops import forest
        from sheep_tpu_torch.runtime import retry

        self._saved = (retry.sync_outputs, forest._live_links_np,
                       forest._PlateauSched.assist, forest.vremap_compact)
        retry.sync_outputs = self._timed("sync", self._saved[0])
        forest._live_links_np = self._timed("boundary_fetch", self._saved[1])
        forest._PlateauSched.assist = self._timed("assist", self._saved[2])
        forest.vremap_compact = self._timed("remap", self._saved[3])
        return self

    def __exit__(self, *exc):
        from sheep_tpu_torch.ops import forest
        from sheep_tpu_torch.runtime import retry

        (retry.sync_outputs, forest._live_links_np,
         forest._PlateauSched.assist, forest.vremap_compact) = self._saved
        return False

    def record(self) -> dict:
        return {f"{name}_s": t for name, (_, t) in self.parts.items()} | {
            f"{name}_calls": c for name, (c, _) in self.parts.items()}


#: the ladder the resilient phase runs: every rung the port has
RESILIENT_LADDER = ("single", "host", "stream", "spill")


def resilient_run(tail, head, device, ckdir, plan=None, **kw):
    """One ``runtime.build_graph_resilient`` on ``device`` with its
    checkpoints in ``ckdir`` and ``plan`` (site, at, kind, times)
    installed; returns (seq, forest, config), a BuildKilled propagates."""
    from sheep_tpu_torch.runtime import (FaultPlan, RuntimeConfig,
                                         build_graph_resilient, clear_plan,
                                         install_plan)

    kw.setdefault("ladder", RESILIENT_LADDER)
    cfg = RuntimeConfig(checkpoint_dir=ckdir, backoff_base_s=0.0, **kw)
    if plan is not None:
        install_plan(FaultPlan(*plan))
    try:
        seq, forest = build_graph_resilient(tail, head, config=cfg,
                                            device=device)
    finally:
        clear_plan()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return seq, forest, cfg


def event_kinds(cfg) -> dict:
    kinds: dict = {}
    for e in cfg.events:
        kinds[e[0]] = kinds.get(e[0], 0) + 1
    return kinds


def resilient_real(device, data, hybrid_wall: float):
    """The fault-tolerant build at real size on the card: equal to the
    oracle, no degrade, K1 launched on the single rung; its wall beside
    the streamed hybrid's, and its parts from the build's own trace
    (SHEEP_TRACE: the prep and rung spans, the dispatch spans), from
    :class:`SaveRecorder` (each snapshot's seconds and bytes) and from
    :class:`LoopRecorder` (the loop's device waits, boundary fetches,
    host assists and remaps)."""
    import tempfile

    from sheep_tpu_torch.obs import trace

    tail, head, want_seq, want = data
    with tempfile.TemporaryDirectory(prefix="sheep-resilient.") as tmp:
        path = os.path.join(tmp, "build.trace")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with SaveRecorder() as saves, LoopRecorder() as loop, \
                env_set({"SHEEP_TRACE": path}):
            (seq, forest, cfg), wall, launches = counted_build(
                lambda: resilient_run(tail, head, device,
                                      os.path.join(tmp, "ckpt")),
                "real-size resilient build")
        trace.close_recorder()
        records, _, _ = trace.read_trace(path, "strict")
    if not forest_equal(seq, forest, want_seq, want):
        raise AssertionError("real-size resilient build differs from the "
                             "oracle")
    kinds = event_kinds(cfg)
    if "degrade" in kinds:
        raise AssertionError(f"real-size resilient build degraded with no "
                             f"fault: {cfg.events}")

    def spans(name):
        return [r for r in records if r["k"] == "span" and r["name"] == name]

    rung_s = sum(r["dur"] for r in spans("rung"))
    in_rung = [x["s"] for x in saves.saves if x["boundary"] > 0]
    rec = {"records": len(tail), "links": saves.saves[0]["links"],
           "wall_s": wall, "hybrid_wall_s": hybrid_wall,
           "prep_s": sum(r["dur"] for r in spans("prep")),
           "rung_s": rung_s,
           # the dispatch spans cover each dispatch's host enqueue; its
           # device work is waited for in the sync after it (sync_s)
           "enqueue_s": sum(r["dur"] for r in spans("dispatch")),
           "dispatches": len(spans("dispatch")),
           "checkpoint_s": sum(x["s"] for x in saves.saves),
           # the rung's loop without its checkpoint writes (the boundary
           # fetches stay in it)
           "loop_s": rung_s - sum(in_rung), **loop.record(),
           "boundaries": kinds.get("checkpoint", 0),
           "save_bytes": [x["bytes"] for x in saves.saves],
           "save_s": [x["s"] for x in saves.saves],
           "k1_launches": launches, "events": kinds}
    if device.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log("resilient " + json.dumps({"case": "real_size", **rec}))
    return rec


@contextlib.contextmanager
def chunk_patched(wrap):
    """Replace ``ops.forest.fixpoint_chunk`` (the chunk dispatch's body)
    by ``wrap(real)`` inside the block: a seam, no knob in the package."""
    from sheep_tpu_torch.ops import forest

    real = forest.fixpoint_chunk
    forest.fixpoint_chunk = wrap(real)
    try:
        yield
    finally:
        forest.fixpoint_chunk = real


def _oom_chunk(real):
    def chunk(lo, hi, n, levels, jrounds):
        if lo.device.type != "cuda":  # the CPU rehearsal: the same type
            raise torch.cuda.OutOfMemoryError("CPU rehearsal")
        # an impossible allocation on the card: 1 PiB
        torch.empty(1 << 50, dtype=torch.uint8, device=lo.device)
        raise AssertionError("an allocation of 1 PiB succeeded")
    return chunk


#: cycles the watchdog case holds its chunk on the card (about 2 s at the
#: H100's 1.98 GHz boost clock, longer at a lower one)
HOLD_CYCLES = 4_000_000_000


def _held_chunk(real):
    def chunk(lo, hi, n, levels, jrounds):
        if lo.device.type == "cuda":
            torch.cuda._sleep(HOLD_CYCLES)
        else:  # the CPU rehearsal holds the host instead
            time.sleep(HOLD_CYCLES / 2e9)
        return real(lo, hi, n, levels, jrounds)
    return chunk


def resilient_faults(device, data):
    """On ``data`` (R-MAT 2^20 x 8): the uninterrupted build, then a kill
    at every checkpoint boundary in turn, each followed by a resume that
    must give the uninterrupted forest and show a ``resume`` event; then
    an injected chunk fault twice (retries), a forced degrade single ->
    host, a dispatch that raises a real out-of-memory error (retryable,
    its budget exhausted, degraded) and a dispatch held on the card past
    the watchdog (DeadlineExceeded, then a retry or a degrade).  Every
    forest equals the oracle; the unforced runs (the uninterrupted build
    and every resume) never degrade.  Last, K1 failing to launch must fail
    the build (:func:`k1_failure`)."""
    import tempfile

    from sheep_tpu_torch.runtime import BuildKilled

    tail, head, want_seq, want = data
    recs = []

    def run(case, plan=None, patch=None, expect=None, **kw):
        threads = threading.active_count()
        with tempfile.TemporaryDirectory(prefix="sheep-resilient.") as tmp, \
                (chunk_patched(patch) if patch is not None
                 else contextlib.nullcontext()):
            reset_counts()
            t0 = time.perf_counter()
            seq, forest, cfg = resilient_run(tail, head, device,
                                             os.path.join(tmp, "ckpt"),
                                             plan, **kw)
            wall = time.perf_counter() - t0
            # a watchdog's abandoned attempts end once their held work
            # has run: wait for their threads, so none outlives the script
            deadline = time.monotonic() + 120
            while threading.active_count() > threads \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
        if not forest_equal(seq, forest, want_seq, want):
            raise AssertionError(f"resilient ({case}) differs from the "
                                 f"oracle")
        kinds = event_kinds(cfg)
        rec = {"case": case, "records": len(tail), "wall_s": wall,
               "k1_launches": read_counts()["fused_jump"], "events": kinds,
               "degrades": [e[1:] for e in cfg.events if e[0] == "degrade"]}
        log("resilient " + json.dumps(rec))
        if expect is not None and not expect(kinds, rec["degrades"]):
            raise AssertionError(f"resilient ({case}): unexpected events "
                                 f"{cfg.events}")
        recs.append(rec)
        return cfg

    base = run("uninterrupted",
               expect=lambda k, d: "degrade" not in k and "retry" not in k)
    if recs[-1]["k1_launches"] <= 0:
        raise AssertionError("resilient build: K1 was not launched")
    boundaries = event_kinds(base).get("checkpoint", 0)
    if boundaries < 3:
        raise AssertionError(f"resilient build: {boundaries} boundaries, "
                             f"too few to exercise resume")
    resumes = []
    for k in range(boundaries):
        with tempfile.TemporaryDirectory(prefix="sheep-resilient.") as tmp:
            ckdir = os.path.join(tmp, "ckpt")
            t0 = time.perf_counter()
            try:
                resilient_run(tail, head, device, ckdir,
                              ("boundary", k, "kill"))
            except BuildKilled:
                pass
            else:
                raise AssertionError(f"kill at boundary {k} did not fire")
            killed_s = time.perf_counter() - t0
            reset_counts()
            t0 = time.perf_counter()
            seq, forest, cfg = resilient_run(tail, head, device, ckdir,
                                             resume=True)
            resume_s = time.perf_counter() - t0
        resumed = [e for e in cfg.events if e[0] == "resume"]
        if not resumed or not forest_equal(seq, forest, want_seq, want):
            raise AssertionError(f"resume after a kill at boundary {k}: "
                                 f"resumed={resumed}, forest equal="
                                 f"{forest_equal(seq, forest, want_seq, want)}")
        launches = read_counts()["fused_jump"]
        # an unforced run: no degrade, and a resume on the single rung
        # runs its remaining chunks on the card, through K1
        if "degrade" in event_kinds(cfg) or (
                resumed[0][1] == "single" and launches <= 0):
            raise AssertionError(f"resume after a kill at boundary {k}: "
                                 f"k1_launches={launches}, events "
                                 f"{cfg.events}")
        resumes.append({"boundary": k, "killed_s": killed_s,
                        "resume_s": resume_s, "resumed": list(resumed[0][1:]),
                        "k1_launches": launches})
    log("resilient " + json.dumps({"case": "kill_and_resume",
                                   "records": len(tail),
                                   "boundaries": boundaries,
                                   "resumes": resumes}))
    run("retry", ("chunk", 1, "xla", 2),
        expect=lambda k, d: k.get("retry", 0) >= 1 and not d)
    run("forced_degrade", ("chunk", 0, "xla", -1), max_retries=1,
        expect=lambda k, d: [x[:2] for x in d] == [("single", "host")])
    run("cuda_oom", patch=_oom_chunk, max_retries=1,
        expect=lambda k, d: len(d) == 1 and "OutOfMemoryError" in d[0][2])
    run("watchdog", patch=_held_chunk, watchdog_s=0.5,
        expect=lambda k, d: ("retry" in k and not d) or (
            len(d) == 1 and ("DeviceHung" in d[0][2]
                             or "DeadlineExceeded" in d[0][2])))
    if device.type == "cuda":  # K1 launches only on the card
        k1_failure(device, tail, head)
    return recs, resumes


class FailingK1:
    """K1's library with its launch entry point failing (CUDA error 700,
    an illegal address) and every other entry point the real one."""

    def __init__(self, real):
        self.real = real

    def __getattr__(self, name):
        return getattr(self.real, name)

    def sheep_fused_jump(self, *args):
        return 700


def k1_failure(device, tail, head):
    """K1 failing to launch on the single rung: the build raises, with no
    retry and no degrade (a kernel fault on the card is never finished on
    the host)."""
    import tempfile

    from sheep_tpu_torch.ops import fused_jump
    from sheep_tpu_torch.runtime import RuntimeConfig, build_graph_resilient

    real = fused_jump.load_library
    lib = FailingK1(real())
    fused_jump.load_library = lambda: lib
    try:
        with tempfile.TemporaryDirectory(prefix="sheep-resilient.") as tmp:
            cfg = RuntimeConfig(checkpoint_dir=os.path.join(tmp, "ckpt"),
                                backoff_base_s=0.0, ladder=RESILIENT_LADDER)
            try:
                build_graph_resilient(tail, head, config=cfg, device=device)
            except RuntimeError as exc:
                if "fused_jump kernel launch failed" not in str(exc):
                    raise
                err = f"{type(exc).__name__}: {exc}"
            else:
                raise AssertionError("a failing K1 launch did not fail the "
                                     "resilient build")
    finally:
        fused_jump.load_library = real
    kinds = event_kinds(cfg)
    if "retry" in kinds or "degrade" in kinds:
        raise AssertionError(f"a failing K1 launch was retried or degraded: "
                             f"{cfg.events}")
    log("resilient " + json.dumps({"case": "k1_launch_failure",
                                   "records": len(tail), "raised": err,
                                   "events": kinds}))


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
    log(f"build: K1, P1/P2 and the native host runtime in "
        f"{build_kernels():.2f}s")
    k1 = k1_phase(device)
    probes, _, probe_counts = probe_phase(device)
    golden_phase(device)
    real_data = real_inputs(23, 26, 0)
    real, recorder = real_size_phase(device, data=real_data)
    kept = {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in recorder.kept.items()}
    k1.append(k1_case("main_path", kept["lo"], kept["hi"], kept["n"],
                      kept["levels"], device, timed=True, f=kept["f"],
                      sorted_links=kept["sorted_links"]))
    del kept
    recorder.kept = None
    native_phase(device, real_data)
    spec_outcomes_phase(device)
    fetch_phase(device)
    small_data = real_inputs(20, 23, 1)
    streaming_phase(device, real_data, small_data)
    part_rec = partition_phase(device, real_data, small_data)
    cli_phase(device, real_data, part_rec)
    # the default tail's last run (the runs in between are other arms)
    main_run = next(r for r in reversed(real) if r["arm"] == "stream")
    resilient_real(device, real_data, main_run["wall_s"])
    del real_data
    device_phase(device, small_data)
    resilient_faults(device, small_data)
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
        # the first real-size run's K1 calls and their summed device time
        "main_path_calls": real[0]["k1_calls"],
        "main_path_ms": real[0]["k1_device_ms"],
    }]
    probe_kernels = (
        ("add_one", "add_one_plain", "scripts/pallas_probe.py:42",
         "one PyTorch call, x + 1 (also the plain version)"),
        ("jump_step", "jump_step_plain", "scripts/pallas_probe.py:74",
         "none: a gather, a compare and a select are three calls"))
    for name, plain, replaces, library in probe_kernels:
        cases = [r for r in probes if r["kernel"] == name]
        big = max((r for r in cases if r["layout"] == "aligned"),
                  key=lambda r: r["n"])
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
            **({"gather_only_ms": big["gather_only_ms"]}
               if name == "jump_step" else {}),
        })
    log(json.dumps({"kernels": kernels}))
    log(card)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
