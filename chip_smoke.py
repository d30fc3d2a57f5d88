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
   on the serial arm (SHEEP_STREAM_HANDOFF=0), then again on the default
   tail; every run equals the host oracle bit for bit.  The first run
   records the shape (width, E, L, sorted or not, groups) and device
   time of every K1 call and keeps the first chunk round's input, on
   which K1's three orders are then timed against the plain version as
   in phase 3;
6b. the native host runtime (``native`` line) on the real-size graph:
   the numpy degree order against the fused native sort, the blocked
   fused build against edges_to_links + the plain fold, the links fold on
   1 thread and on the host's granted cores (which it must use), and the
   hybrid, equal to the oracle, with seq and pst from the card
   (pst_source), prefetch_s, pst_wait_s and fold_s; the host's cores and
   the OpenMP runtimes mapped into the process;
7. the window stream's fetch thread alone, as one window: 2^24 random
   links at n = 2^23 fetched in slices of 2^18 and 2^21 links, equal to
   the table, with its breakdown (pinned allocation, copy enqueue, event
   wait, the copies' device time) and rate;
8. the out-of-core builds: build_graph_streaming_hosted and
   build_graph_streaming on hep-th in blocks of 4096 (the golden
   TREEFAQS line), build_graph_streaming on rmat_edges(20, 2^23, seed=1)
   in 4 blocks, and build_graph_streaming_hosted on the real-size graph
   in blocks of 2^24 records, each equal to the oracle;
8b. the partitioner (``partition`` line): hep-th built by
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
8c. the CLI (``cli`` line), the user's entry point: ``graph2tree
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
   to phase 8b's), each process timed; the real-size files stay for
   9d;
8d. the external-memory build (``ext`` line), host code that loads no
   torch: the reference's published deployment (EXTBENCH_r01.json), an
   R-MAT graph of 2^26 records over 2^20 vertices written in 16 chunks
   (seeds 17+i, no sidecar, 768 MiB), built by ``graph2tree E.dat -o
   E_ext.tre`` under SHEEP_MEM_BUDGET=192M with no ``--ext`` (the budget
   must route it to ext, the process must peak under 192 MiB (VmHWM
   where /proc has it, else VmRSS sampled every 5 ms) and never load
   torch, and the tree must equal the unbudgeted
   in-RAM run's byte for byte), with its wall, records/s and perf
   record; ``plan --explain`` on E.dat under the budget (it must choose
   ext); ``graph2tree G.dat --ext -s S.seq`` on 8c's files at the default
   block and, unbudgeted, with SHEEP_EXT_BLOCK=4M, each equal to ``-i
   -r``'s T.tre byte for byte; the fault-tolerant build on the real-size
   records with ladder single -> ext, ``edges_path`` G.dat and 4M
   blocks, the single rung's second dispatch failing for good (K1
   launched on single, a degrade single -> ext, ext-block events, equal
   to the oracle);
8e. the tournament supervisor (``supervise`` line), host code that
   loads no torch: ``python -m sheep_tpu_torch.cli.supervise G.dat -w 4
   -d S -o T_sup.tre`` on 8c's real-size file, its process tree sampled
   every 5 ms (``TreeSampler``: each leg's peak RSS, torch mapped into
   none), the tree equal to 8c's T.tre and the oracle, each leg once;
   then with ``SHEEP_FAULT_PLAN=kill@0:1,corrupt@1:0,stop@1:0`` (exit 1
   after all three fired) and resumed in the same ``-d``: only the legs
   the manifest had not finished re-dispatched, the same tree; then
   ``supervise --status --json``;
8f. the distributed out-of-core build (``distext`` line), host code: the
   reference's DISTEXTBENCH shape (a file 4x the per-leg budget over 2
   legs; at 192M a leg over EXTBENCH's 2^26 records, the card host's
   interpreter leaving too little of 96M, PERF.md §4): ``graph2tree
   --distext`` under the budget (each leg's sampled peak inside it, no
   torch), the single-host ext build and the in-RAM build, the three
   trees equal byte for byte; a map leg SIGKILLed once its first block
   checkpoint lands, re-dispatched alone and resumed from the
   checkpoint; the tight-budget auto-route (``graph2tree.main`` in this
   process, no ``--distext``), each tree the same;
8f'. the remote build workers (``remote`` line), host code in a child
   process (``python -m sheep_tpu_torch.scripts.remote_drive run``, its
   process tree sampled): two worker processes with state dirs of their
   own, ``graph2tree --distext`` on 8f's file with its legs shipped to
   them (SHEEP_WORKER_TRANSPORT=ship) equal to 8f's tree and the in-RAM
   oracle, again with one artifact return torn (a netfault at the
   ``wart`` site) re-dispatching exactly that leg, ``supervise
   --status`` listing the remote legs; each worker's peak RSS beside the
   budget, torch mapped into none;
8g. the analysis tools (``tools`` line), host code: the six tools
   (``tree2dot``, ``tree2adj``, ``graph2adj``, ``vfennel``, ``efennel``,
   ``read_partition``), each a process started as the ``util/`` shims
   start the reference's, on hep-th (the golden lines: ECV(down) 521,
   2811 edges cut, sizes 3409/4201), then ``vfennel``, ``efennel`` and
   ``read_partition`` on 8c's 2^23 x 8 G.dat (read_partition's report
   equal to 8b's at 2 parts); each one's wall and sampled peak RSS, torch
   mapped into none;
8h. the serve store (``serve`` line), host code in a child process that
   never loads torch (``python -m sheep_tpu_torch.scripts.serve_drive
   run``, its process tree sampled): ``ServeCore.bootstrap`` on 8c's
   T.tre/S2.seq (built on the card through K1) with G.dat as the graph,
   2 parts; 2^16 inserts of ``rmat_edges(23, 2^16, seed=5)`` in batches
   of 64 from 4 threads beside part and subtree queries of 2^10 vids,
   killed by ``SHEEP_SERVE_FAULT_PLAN`` at the 512th insert and
   reopened (no acknowledged insert lost; the state equal to the log
   replayed into a copy of the fresh dir); ``seal_snapshot``, a
   re-sequence equal to the host oracle and one killed at its fold and
   resumed, equal to it; ``ecv()`` equal to the evaluator; ``fsck`` of
   the state dirs passing and of a WAL with one byte flipped failing;
   bootstrap, insert, query, fsync, recovery and re-sequence figures;
8h'. the serve daemon as a cluster (``daemon`` line), host code in a
   child process (``python -m sheep_tpu_torch.scripts.daemon_drive
   run``, its process tree sampled): 8h's recovered 2^23 store led by a
   ``cli.serve`` process, two followers bootstrapped over the wire, 8h's
   2^20 store a second tenant evicted and restored; 2^14 inserts in
   batches of 64 from 4 clients beside follower reads, the leader killed
   at its 128th insert, a follower elected, the killed node back as a
   fenced follower; every acknowledged insert in the new leader's WAL,
   three equal state crcs, ``supervise --status --json`` agreeing;
   SCRUB, a CORRUPTed follower quarantined and healed; fsck of every
   state dir; torch mapped into none;
8h''. the routed fleet (``fleet`` line), host code in a child process
   (``python -m sheep_tpu_torch.scripts.fleet_drive run``, its process
   tree sampled), the reference's FLEETBENCH at 8h's sizes: two
   single-node clusters (``cli.serve``), 8h's 2^23 store as the hot
   tenant on the cluster the ring gives it, copies of 8h's 2^20 store as
   each cluster's default tenant, a warm tenant beside hot and a cold one
   on the other cluster, behind ``cli.route`` with ``SHEEP_REBALANCE=1``;
   inserts on all three and 16-vid reads on hot through the router; the
   rebalancer's own verdict moves hot to the other cluster under that
   traffic; every tenant's acknowledged inserts applied once at its
   final owner, the source answering ``ERR moved``, hot's crc at the cut
   equal to the source's sealed one, every ``PART`` answer read through
   the router equal to the final owner's, ``cli.top --json`` showing the
   ``MIG`` column and then the new placement, fsck of every state dir;
   each process's peak RSS; torch mapped into none;
10. the fault-tolerant build (``runtime.build_graph_resilient``, ladder
    single -> host -> stream -> spill, checkpoints in a temporary
    directory) on the real-size graph: equal to the oracle, no degrade,
    K1 launched on the single rung; wall beside the streamed hybrid's of
    phase 6, prep/rung/enqueue seconds from the build's own trace
    (SHEEP_TRACE), the loop's device waits, boundary fetches, host
    assists and remaps, each snapshot's seconds and bytes, peak device
    memory; its trace is kept for 10c;
10c. the ``trace`` tool (``trace`` line), as processes: on 10's trace
    (the rung explanation names the plan and every rung the build's
    events record, ``--json`` the same lines), and ``--merge`` of 8h's
    two store processes (the killed one and its restart), where the
    killed request's id joins records of both;
10b. the sharded mesh build (``mesh`` line): the port's mesh given W
    workers on the one card through the ``parallel.mesh.mesh_devices``
    seam; ``build_graph_distributed`` (the chunked build, unified global
    rounds) on the real-size graph at W = 2 and, for the script's time,
    on rmat_edges(22, 2^25, seed=0) at W = 4 and 8; on that graph too the
    split form
    (``unified=False``) and the map-only partials merged on the card by
    ``merge_forests_device`` at W = 4, and the fault-tolerant build from
    its ``mesh`` rung at W = 4 with checkpoints (no degrade); on
    rmat_edges(20, 2^23, seed=1) the single-dispatch twin
    (SHEEP_MESH_KERNEL=loop) and both mesh streaming builds in 4 blocks
    at W = 4; each equal to the oracle bit for bit, K1 launched, and on
    every worker where the build counts per worker; each run's wall,
    timings (prep/map/reduce seconds, rounds), comm model and peak
    device memory.  Then ``graph2tree data/hep-th.dat -i -r -f -c`` as a
    process joined through SHEEP_COORDINATOR at world size 1 over NCCL
    with two workers on the card: the golden TREEFAQS line, ``Tree is
    valid.``, K1 launched in it;
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
12b. the treewidth mode (``jxn`` line): hep-th ``graph2tree -k -e -j -f
    -c`` as a process (TREEFAQS width:551, ``Tree is valid.``, no torch)
    and ``-i -r -k -e -j -f -c`` in process, its degree sort on the card
    (the same lines and .tre); the reference's published configuration
    ``graph2tree R.dat -k -e -j -w 64 -m 16384`` on R-MAT 2^20 x 8, timed
    as a process with its peak RSS, max width and fill, its tree equal to
    the insert run here and valid under ``core.validate``;
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.harness.peaks import HBM_BYTES_PER_S, k1_bound_s
from portbench.harness.trace import K1Recorder as DescentRecorder

ROOT = os.path.dirname(os.path.abspath(__file__))
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
            "bound_ms": k1_bound_s(int(lo.shape[0]), levels, width) * 1e3}


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


#: the serial arm's knob
SERIAL_ARM = {"SHEEP_STREAM_HANDOFF": "0"}


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


class K1Recorder(DescentRecorder):
    """The benchmark's recorder of K1's descents on the card
    (``descents``), which wraps the descent seam
    ``ops.forest._lift_descend`` while entered, with no knob in the
    package.  For this script it also records, per descent, the table
    width, E, L, whether the links came sorted, the launches it made (one
    per table group) and their device time (CUDA events around each
    launch of ``ops.fused_jump.jump_group_cuda``), and keeps a copy of the
    first chunk round's input (the second descent: the first is the
    jump-only opener), moved to host memory when the recorder exits."""

    keep_call = 1

    def __init__(self):
        super().__init__()
        self.calls: list = []
        self.events: list = []
        self.kept: dict | None = None

    def __enter__(self):
        from sheep_tpu_torch.ops import forest, fused_jump

        super().__enter__()
        self._wrapped = (forest._lift_descend, fused_jump.jump_group_cuda)
        descend, launch = self._wrapped

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

        forest._lift_descend, fused_jump.jump_group_cuda = self._wrapped
        super().__exit__(*exc)
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
    """The real-size hybrid on both arms: the default streamed tail first
    and third, the serial arm second; returns the runs' records and the
    first run's K1 recorder.  ``data``: the
    (tail, head, want_seq, want) of :func:`real_inputs`, made here if
    None."""
    from sheep_tpu_torch.ops.build import build_graph_hybrid

    tail, head, want_seq, want = data if data is not None \
        else real_inputs(log_n, log_e, 0)
    recs = []
    recorder = K1Recorder()
    # the default tail (streamed) runs first and third, the serial arm
    # between, so the two arms meet on one card in turns
    arms = ["stream"] * (runs - 1) + ["serial", "stream"]
    envs = {"stream": {}, "serial": SERIAL_ARM}
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
        recs.append(rec)
    if recorder.kept is None:
        raise AssertionError(f"real-size hybrid: no chunk round reached K1 "
                             f"({recorder.calls})")
    return recs, recorder


def fetch_phase(device: torch.device, n: int = 1 << 23, links: int = 1 << 24,
                slices=(1 << 18, 1 << 21)):
    """The window stream's fetch thread (``ops.build._WindowStream``, one
    window) alone on the card, nothing else running: a table of 2^24
    random links at n = 2^23 (6-byte packed, 100 MB) fetched in slices of
    2^18 links (the default) and 2^21, its host copy equal to the table.
    Logs the thread's breakdown (``ops.build.fetch_phases``: pinned
    allocation, copy enqueue and event wait on the host, the copies'
    device time) and its rate."""
    from sheep_tpu_torch.ops.build import _WindowStream

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
        f = _WindowStream(lo, hi, n, links, slice_links, windows=1)
        if f.join(timeout=600) or f.failed:
            raise AssertionError(f"fetch: the stream did not finish "
                                 f"({f.error!r})")
        wall = time.perf_counter() - t0
        got_lo, got_hi = f.window(0)
        if not (np.array_equal(got_lo, want_lo)
                and np.array_equal(got_hi, want_hi)):
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


def timed_call(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def native_phase(device: torch.device, data):
    """The native host runtime on the real-size graph: the numpy degree
    order against the fused native sort; the blocked fused build against
    edges_to_links + the plain fold; the links fold on 1 thread and on
    the host's granted cores; then the hybrid, its seq and pst from the
    card.  Every pair equal, each side timed (host seconds)."""
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
    keys = ("pst_source", "prefetch_s", "pst_wait_s", "fold_s", "loop_s",
            "stream_mode")
    perf: dict = {}
    # on the card the prep counts pst and the prefetch fetches seq and
    # pst, so no host order enters the hybrid
    (seq, forest), wall, launches = counted_build(
        lambda: build_graph_hybrid(tail, head, device=device, perf=perf),
        "native: hybrid")
    if not forest_equal(seq, forest, want_seq, want):
        raise AssertionError("native: hybrid differs from the oracle")
    if device.type == "cuda" and perf.get("pst_source") != "card":
        raise AssertionError(f"native: the hybrid on the card took seq and "
                             f"pst from the host: {perf}")
    rec["hybrid"] = {"wall_s": wall, "k1_launches": launches,
                     **{k: perf.get(k) for k in keys}}
    log("native " + json.dumps(rec))
    return rec


#: the 2-part hep-th report of the reference's published run
HEP_BIPARTITION = {"edges_cut": 2811, "vcom_vol": 2061, "ecv_hash": 1311,
                   "ecv_down": 521, "ecv_up": 1539}


#: the part counts at which the partition phase also runs the in-memory
#: evaluator at real size (the ``tools`` phase's read_partition runs it at
#: 2 parts)
DENSE_EVAL_PARTS = (64,)


def partition_phase(device: torch.device, real, small,
                    real_parts=(2, 16, 64), eval_parts=(2, 64),
                    block: int = 1 << 24):
    """Partitions of trees built on the card: hep-th by the hybrid
    (K1 counted) at 2-9 parts against data/hepth-ecv-baseline.json and
    the golden 2-part report; four partial hep-th forests built on the
    card over one sequence, merged to the whole tree; the native forward
    pass against the python one on ``small``; the real-size tree at
    ``real_parts`` parts, at ``eval_parts`` of them the streamed
    evaluator (its printed report kept) and at DENSE_EVAL_PARTS the
    in-memory one against it, each timed (the ``tools`` phase holds
    ``read_partition``'s in-memory report against the streamed one at 2
    parts)."""
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
        stream, stream_s = timed_call(
            lambda: evaluate_partition_streamed(
                part.parts, lambda: _blocks(tail, head, block), pos, p,
                len(tail)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stream.print()
        entry = {"parts": p, "partition_s": part_s,
                 "evaluate_streamed_s": stream_s,
                 "created": part.max_part + 1,
                 "ecv_down": stream.ecv_down,
                 "edges_cut": stream.edges_cut,
                 "report": buf.getvalue().splitlines()}
        if p in DENSE_EVAL_PARTS:
            dense, entry["evaluate_s"] = timed_call(
                lambda: evaluate_partition(part.parts, tail, head, rseq, p,
                                           max_vid=mv,
                                           file_edges=len(tail)))
            if vars(dense) != vars(stream):
                raise AssertionError(
                    f"partition: the evaluators differ at {p} parts: "
                    f"{vars(dense)} vs {vars(stream)}")
        rec["real"].append(entry)
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
              factor: int = 8, keep: str | None = None):
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
    partition phase's record).  ``keep``: a directory that receives the
    real-size files (G.dat, S.seq, T.tre) and is left in place, for the
    ext phase."""
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
        tmp = keep or tempfile.mkdtemp(prefix="sheep-cli-real.")

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
        if tmp != keep:
            shutil.rmtree(tmp, ignore_errors=True)
    rec["checks"] = checks
    log("cli " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"cli: checks failed: {checks}")
    return rec


#: one tool run as a process through ``python -c``: ``main`` runs as
#: ``python -m`` would run it, with ops.extmem's two entry points wrapped
#: to record their events and perf record; at exit, however the tool
#: ended, one ``proc_record {...}`` line on stderr: the process's peak
#: RSS, whether torch was loaded, and what the ext build did.  The peak is
#: the larger of VmHWM, where /proc reports it, and VmRSS sampled every
#: 5 ms from the start.  The GPU machine's /proc has no VmHWM, and its
#: ru_maxrss (recorded, not used) carries the parent's peak across exec;
#: ``start_rss_bytes`` is the RSS the tool's process started from
PROC_WRAPPER = """\
import json, resource, runpy, sys, threading, time
def rss_now():
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024
    return 0
seen = {"start": rss_now()}
seen["peak"] = seen["start"]
def sample():
    while True:
        seen["peak"] = max(seen["peak"], rss_now())
        time.sleep(0.005)
threading.Thread(target=sample, daemon=True).start()
from sheep_tpu_torch.ops import extmem
rec = {"ext_calls": 0, "events": [], "perf": {}}
def wrap(fn, count):
    def inner(*a, **kw):
        rec["ext_calls"] += count
        kw["perf"] = rec["perf"]
        if count:
            kw["events"] = rec["events"]
        return fn(*a, **kw)
    return inner
extmem.build_forest_extmem = wrap(extmem.build_forest_extmem, 1)
extmem.streaming_degree_sequence = wrap(extmem.streaming_degree_sequence, 0)
mod = sys.argv.pop(1)
sys.argv[0] = mod
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
finally:
    seen["peak"] = max(seen["peak"], rss_now())
    hwm = None
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmHWM:"):
                hwm = int(ln.split()[1]) * 1024
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    blocks = [e for e in rec["events"] if e[0] == "ext-block"]
    out = {"peak_rss_bytes": max(hwm or 0, seen["peak"]),
           "vmhwm_bytes": hwm, "ru_maxrss_bytes": maxrss,
           "sampled_rss_bytes": seen["peak"],
           "start_rss_bytes": seen["start"],
           "torch_loaded": "torch" in sys.modules,
           "ext_calls": rec["ext_calls"], "ext_blocks": len(blocks),
           "strategies": sorted({e[3] for e in blocks}),
           "perf": rec["perf"]}
    sys.stderr.write("\\nproc_record " + json.dumps(out) + "\\n")
"""


def run_wrapped(tool: str, argv: list, env: dict | None = None,
                timeout: int = 600):
    """One CLI tool as a process of its own through PROC_WRAPPER; returns
    (stdout, wall s, its proc_record)."""
    full_env = dict(os.environ)
    full_env.update(env or {})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", PROC_WRAPPER,
         f"sheep_tpu_torch.cli.{tool}"] + argv,
        capture_output=True, text=True, cwd=ROOT, env=full_env,
        timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{tool} {' '.join(argv)} exited "
                             f"{proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    found = re.findall(r"^proc_record (.*)$", proc.stderr, re.M)
    return proc.stdout, wall, json.loads(found[-1])


#: the reference's published ext deployment (EXTBENCH_r01.json,
#: scripts/extbench.py): 2^26 R-MAT records over 2^20 vertices, written
#: in 16 chunks of 2^22 records with seeds 17+i and no sidecar, a 768 MiB
#: file 4x over a 192M SHEEP_MEM_BUDGET
EXT_BUDGET = "192M"
EXT_BUDGET_BYTES = 192 << 20


def write_extbench(path: str, log_n: int = 20, records: int = 1 << 26,
                   chunk: int = 1 << 22, seed: int = 17) -> float:
    """Write the EXTBENCH graph in bounded chunks with the port's R-MAT
    generator and its XS1 record layout (sidecar-less, as the reference's
    generator writes it); returns the seconds taken."""
    from sheep_tpu_torch.io.edges import _XS1_DTYPE
    from sheep_tpu_torch.utils import rmat_edges

    t0 = time.perf_counter()
    with open(path, "wb") as f:
        done = i = 0
        while done < records:
            m = min(chunk, records - done)
            tail, head = rmat_edges(log_n, m, seed=seed + i)
            rec = np.empty(m, dtype=_XS1_DTYPE)
            rec["tail"] = tail
            rec["head"] = head
            rec["weight"] = 1.0
            f.write(rec.tobytes())
            done += m
            i += 1
    return time.perf_counter() - t0


def ext_phase(device: torch.device, real, gdir: str,
              extbench: dict | None = None):
    """The external-memory build, which is host code and loads no torch
    (``ext`` line):

    1. the EXTBENCH graph (``write_extbench``, or ``extbench`` for a
       smaller one; written to ``gdir``, where the distext phase reads
       it again) built by ``graph2tree E.dat -o E_ext.tre`` under
       SHEEP_MEM_BUDGET=192M with no ``--ext``: the budget must route it
       to ext, the process must peak under 192 MiB (PROC_WRAPPER's
       peak) and never load torch,
       and its tree must equal the unbudgeted in-RAM run's byte for byte;
    2. ``graph2tree G.dat --ext -s S.seq`` on the cli phase's real-size
       files in ``gdir``, and unbudgeted with SHEEP_EXT_BLOCK=4M, each
       equal to ``-i -r``'s T.tre byte for byte;
    3. the ext rung on the card's ladder: ``build_graph_resilient`` on
       ``real``'s records with ladder single -> ext, ``edges_path`` G.dat,
       4M blocks and the single rung's second dispatch failing for good: K1
       launched on single, a degrade single -> ext, ext-block events, and
       seq, parent and pst equal to the oracle;
    4. ``plan --explain --assume-rss`` on E.dat under the budget chooses
       ext."""
    import shutil
    import tempfile

    from sheep_tpu_torch.io import read_tree
    from sheep_tpu_torch.runtime import (FaultPlan, RuntimeConfig,
                                         build_graph_resilient, clear_plan,
                                         install_plan, reset_counters)

    rec: dict = {"extbench": {}, "real": {}, "ladder": {}, "plan": {}}
    checks: dict = {}
    tmp = tempfile.mkdtemp(prefix="sheep-ext.")
    try:
        t = lambda name: os.path.join(tmp, name)
        g = lambda name: os.path.join(gdir, name)
        kw = extbench or {}
        rec["extbench"]["write_s"] = write_extbench(g("E.dat"), **kw)
        records = os.path.getsize(g("E.dat")) // 12
        rec["extbench"]["file_bytes"] = os.path.getsize(g("E.dat"))
        out, wall, proc = run_wrapped(
            "graph2tree", [g("E.dat"), "-o", t("E_ext.tre")],
            env={"SHEEP_MEM_BUDGET": EXT_BUDGET})
        rec["extbench"].update(
            budgeted_wall_s=wall, records=records,
            records_per_s=records / wall,
            peak_rss_bytes=proc["peak_rss_bytes"],
            rss_sources={k: proc[k] for k in (
                "vmhwm_bytes", "ru_maxrss_bytes", "sampled_rss_bytes",
                "start_rss_bytes")},
            torch_loaded=proc["torch_loaded"], ext_blocks=proc["ext_blocks"],
            perf=proc["perf"],
            phases=[ln for ln in out.splitlines() if " in: " in ln])
        checks["extbench_routed_ext"] = (proc["ext_calls"] == 1
                                         and proc["ext_blocks"] > 0)
        checks["extbench_under_budget"] = \
            proc["peak_rss_bytes"] < EXT_BUDGET_BYTES
        checks["extbench_no_torch"] = not proc["torch_loaded"]
        out, wall, proc = run_wrapped("graph2tree",
                                      [g("E.dat"), "-o", t("E_ram.tre")])
        rec["extbench"].update(ram_wall_s=wall,
                               ram_peak_rss_bytes=proc["peak_rss_bytes"])
        checks["extbench_ram_in_ram"] = proc["ext_calls"] == 0
        checks["extbench_tree_equals_ram"] = same_files(t("E_ext.tre"),
                                                        t("E_ram.tre"))
        # the planner tool on the same file and budget, with the RSS the
        # budgeted build's process started from pinned
        assume = 40 << 20
        out, wall, _ = run_tool("plan", ["--explain", "--assume-rss",
                                         str(assume), g("E.dat")],
                                env={"SHEEP_MEM_BUDGET": EXT_BUDGET})
        rec["plan"] = {"wall_s": wall, "assume_rss": assume,
                       "text": out.splitlines()}
        checks["plan_chooses_ext"] = "chosen rung: ext " in out

        for name, argv, env in (
                ("ext_default_block", ["--ext"], {}),
                ("ext_block_4M", [], {"SHEEP_EXT_BLOCK": "4M"})):
            out, wall, proc = run_wrapped(
                "graph2tree", [g("G.dat"), *argv, "-s", g("S.seq"), "-o",
                               t(f"{name}.tre")], env=env)
            rec["real"][name] = {
                "wall_s": wall, "peak_rss_bytes": proc["peak_rss_bytes"],
                "torch_loaded": proc["torch_loaded"],
                "ext_blocks": proc["ext_blocks"],
                "strategies": proc["strategies"], "perf": proc["perf"]}
            checks[f"real_{name}_equals_ir"] = (
                proc["ext_calls"] == 1
                and same_files(t(f"{name}.tre"), g("T.tre")))

        tail, head, want_seq, want = real
        cfg = RuntimeConfig(ladder=("single", "ext"), edges_path=g("G.dat"),
                            max_retries=1, backoff_base_s=0.0)
        reset_counters()
        install_plan(FaultPlan("chunk", 1, "xla", -1))
        # the rung streams 4M blocks: the default block's time is measured
        # above, and this run is about the handoff
        try:
            with env_set({"SHEEP_EXT_BLOCK": "4M"}):
                (seq, forest), wall, k1 = counted_build(
                    lambda: build_graph_resilient(tail, head, config=cfg,
                                                  device=device),
                    "ladder single -> ext")
        finally:
            clear_plan()
            reset_counters()
        degrades = [e[:3] for e in cfg.events if e[0] == "degrade"]
        blocks = [e for e in cfg.events if e[0] == "ext-block"]
        rec["ladder"] = {"wall_s": wall, "k1_launches": k1,
                         "degrades": degrades, "ext_blocks": len(blocks),
                         "strategies": sorted({e[3] for e in blocks})}
        checks["ladder_k1_on_single"] = k1 > 0
        checks["ladder_degrades_to_ext"] = degrades == [
            ("degrade", "single", "ext")]
        checks["ladder_ext_blocks"] = len(blocks) > 0
        checks["ladder_equals_oracle"] = forest_equal(seq, forest, want_seq,
                                                      want)
        del seq, forest
        parent, _ = read_tree(g("T.tre"))
        checks["real_tree_is_oracle"] = np.array_equal(parent, want.parent)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["checks"] = checks
    log("ext " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"ext: checks failed: {checks}")
    return rec


#: the port's tools a supervised job runs as legs, by module (and
#: distext verb)
LEG_KINDS = {"degree_sequence": "sort", "graph2tree": "map",
             "merge_trees": "merge", "distext hist": "hist",
             "distext map": "distmap"}


def leg_kind(cmd: str) -> str | None:
    """The LEG_KINDS kind of a ``python -m sheep_tpu_torch.cli.<tool>``
    command line; None for any other process."""
    words = cmd.split()
    if "-m" not in words[:-1]:
        return None
    mod = words[words.index("-m") + 1]
    if not mod.startswith("sheep_tpu_torch.cli."):
        return None
    tool = mod.rsplit(".", 1)[1]
    if tool == "distext" and len(words) > words.index(mod) + 1:
        tool += " " + words[words.index(mod) + 1]
    return LEG_KINDS.get(tool)


def _status(pid: int) -> dict:
    """The Tgid and VmRSS (bytes) of ``/proc/<pid>/status``; a zombie
    has no VmRSS left to count."""
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for ln in f:
            if ln.startswith("Tgid:"):
                out["tgid"] = int(ln.split()[1])
            elif ln.startswith("VmRSS:"):
                out["rss"] = int(ln.split()[1]) * 1024
    return out


class TreeSampler:
    """VmRSS of a process and every descendant of it, sampled every 5 ms
    from this process (the card host's ``/proc`` has no VmHWM, so a
    leg's own report cannot give its peak).  Descendants are found
    through ``/proc/<pid>/task/*/children``, which on the card host also
    lists a process's own threads: an entry whose Tgid is not its pid is
    a thread and is left out.  A record is kept per pid and command
    line, so a forked child is counted apart before and after its exec;
    each has its first and peak RSS, the times it was first and last
    seen, and whether torch's libraries were ever mapped into it
    (``/proc/<pid>/maps``, read at first sight and every 10th sample:
    importing torch takes far longer than that).  ``watch`` is
    called after every sample with the sampler."""

    def __init__(self, root: int, period: float = 0.005, watch=None):
        self.root = root
        self.period = period
        self.watch = watch
        self.procs: dict = {}
        self.t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _tree(self) -> list:
        seen, todo = [], [self.root]
        while todo:
            pid = todo.pop()
            if pid in seen:
                continue
            seen.append(pid)
            try:
                tids = os.listdir(f"/proc/{pid}/task")
            except OSError:
                continue
            for tid in tids:
                try:
                    with open(f"/proc/{pid}/task/{tid}/children") as f:
                        todo += [int(x) for x in f.read().split()]
                except OSError:
                    pass
        return seen

    @staticmethod
    def _torch_mapped(pid: int) -> bool:
        with open(f"/proc/{pid}/maps") as f:
            return any("libtorch" in ln for ln in f)

    def _sample(self, n: int) -> None:
        now = time.perf_counter() - self.t0
        for pid in self._tree():
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = " ".join(c.decode() for c in f.read().split(b"\0")
                                   if c)
                st = _status(pid)
                if st.get("tgid") != pid or "rss" not in st:
                    continue
                rss = st["rss"]
                r = self.procs.get((pid, cmd))
                if r is None:
                    r = self.procs[(pid, cmd)] = {
                        "pid": pid, "cmd": cmd, "start_rss_bytes": rss,
                        "peak_rss_bytes": rss, "first_s": now,
                        "last_s": now, "samples": 0, "torch_mapped": False,
                        "maps_at": -10}
                r["peak_rss_bytes"] = max(r["peak_rss_bytes"], rss)
                r["last_s"] = now
                r["samples"] += 1
                if n - r["maps_at"] >= 10:
                    r["maps_at"] = n
                    r["torch_mapped"] |= self._torch_mapped(pid)
            except (OSError, ValueError):
                continue  # it ended between the walk and the read
        if self.watch is not None:
            self.watch(self)

    def _run(self) -> None:
        n = 0
        while not self._stop.is_set():
            self._sample(n)
            n += 1
            self._stop.wait(self.period)

    def root_record(self) -> dict | None:
        """The root process's record (its command line as sampled
        first)."""
        mine = [r for r in self.procs.values() if r["pid"] == self.root]
        return min(mine, key=lambda r: r["first_s"]) if mine else None

    def legs(self) -> list:
        """The records of the root's descendants that ran one of the
        port's tools (a child between its fork and its exec still shows
        the root's command line and is left out), each with its kind and
        seconds seen alive, in order of start."""
        root = self.root_record()
        out = []
        for r in self.procs.values():
            kind = leg_kind(r["cmd"])
            if r["pid"] == self.root or kind is None \
                    or (root is not None and r["cmd"] == root["cmd"]):
                continue
            rec = {k: v for k, v in r.items() if k != "maps_at"}
            rec["kind"] = kind
            rec["alive_s"] = r["last_s"] - r["first_s"]
            out.append(rec)
        return sorted(out, key=lambda r: r["first_s"])

    def torch_mapped(self) -> bool:
        """Whether torch was mapped into any process of the tree."""
        return any(r["torch_mapped"] for r in self.procs.values())


def by_kind(legs: list) -> dict:
    """Per leg kind: how many ran, the span from the first start to the
    last end, each one's seconds alive and the largest peak RSS."""
    out: dict = {}
    for r in legs:
        k = out.setdefault(r["kind"], {"count": 0, "first_s": r["first_s"],
                                       "last_s": r["last_s"], "alive_s": [],
                                       "peak_rss_bytes": 0})
        k["count"] += 1
        k["first_s"] = min(k["first_s"], r["first_s"])
        k["last_s"] = max(k["last_s"], r["last_s"])
        k["alive_s"].append(r["alive_s"])
        k["peak_rss_bytes"] = max(k["peak_rss_bytes"], r["peak_rss_bytes"])
    for k in out.values():
        k["span_s"] = k.pop("last_s") - k.pop("first_s")
    return out


def run_sampled(argv: list, env: dict | None = None, watch=None,
                timeout: int = 900):
    """``python -m sheep_tpu_torch.cli.<argv[0]> argv[1:]`` as a process
    of its own, its process tree sampled; returns (exit code, stdout,
    stderr, wall s, the sampler)."""
    return run_cmd_sampled(
        [sys.executable, "-m", f"sheep_tpu_torch.cli.{argv[0]}"] + argv[1:],
        env=env, watch=watch, timeout=timeout)


def run_cmd_sampled(cmd: list, env: dict | None = None, watch=None,
                    timeout: int = 900):
    """``cmd`` as a process of its own, its process tree sampled; returns
    (exit code, stdout, stderr, wall s, the sampler)."""
    full_env = dict(os.environ)
    full_env.update(env or {})
    t0 = time.perf_counter()
    # a session of its own, so a timeout stops the legs with the parent
    proc = subprocess.Popen(
        cmd, cwd=ROOT, env=full_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    with TreeSampler(proc.pid, watch=watch) as sampler:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            out, err = proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0, sampler


def _manifest_dispatches(state_dir: str) -> dict:
    with open(os.path.join(state_dir, "manifest.json")) as f:
        return {leg["key"]: leg["dispatches"] for leg in json.load(f)["legs"]}


def supervise_phase(real, gdir: str, workers: int = 4) -> dict:
    """The tournament supervisor at real size (``supervise`` line), on
    the cli phase's files in ``gdir`` (G.dat, R-MAT 2^23 x 8, and T.tre,
    ``-i -r``'s tree, equal to the oracle):

    1. ``supervise G.dat -w 4 -d S -o T_sup.tre`` as a process, its
       process tree sampled: the tree equals T.tre byte for byte and the
       oracle; each leg dispatched once; the wall, each leg kind's span
       and each leg's seconds alive and peak RSS; torch mapped into no
       process of the tree;
    2. with ``SHEEP_FAULT_PLAN=kill@0:1,corrupt@1:0,stop@1:0`` (a map
       leg killed at dispatch, a merge output corrupted after its write,
       the supervisor dead once that merge's second attempt publishes): the
       supervisor exits 1 after all three fired (its ``-v`` event echo),
       then a plain rerun in the same ``-d`` re-dispatches exactly the
       legs the manifest had not finished, and the tree is the same;
    3. ``supervise --status --json -d S``: every leg done, the
       manifest's dispatches."""
    from sheep_tpu_torch.io import read_tree

    rec: dict = {"workers": workers}
    checks: dict = {}
    g = lambda name: os.path.join(gdir, name)
    rc, out, err, wall, sampler = run_sampled(
        ["supervise", g("G.dat"), "-w", str(workers), "-d", g("S"), "-o",
         g("T_sup.tre")])
    if rc != 0:
        raise AssertionError(f"supervise: exit {rc}\n{out}\n{err[-4000:]}")
    legs = sampler.legs()
    dispatches = _manifest_dispatches(g("S"))
    rec["clean"] = {
        "wall_s": wall, "dispatches": sum(dispatches.values()),
        "legs": len(dispatches), "by_kind": by_kind(legs),
        "per_leg": [{k: r[k] for k in ("kind", "pid", "alive_s",
                                       "start_rss_bytes", "peak_rss_bytes")}
                    for r in legs],
        "phases": [ln for ln in out.splitlines() if " in " in ln],
        "stdout_last": out.splitlines()[-1]}
    checks["clean_tree_equals_ir"] = same_files(g("T_sup.tre"), g("T.tre"))
    parent, pst = read_tree(g("T_sup.tre"))
    want = real[3]
    checks["clean_tree_equals_oracle"] = (
        np.array_equal(parent, want.parent)
        and np.array_equal(pst, want.pst_weight))
    del parent, pst
    checks["clean_each_leg_once"] = set(dispatches.values()) == {1}
    checks["clean_no_torch"] = not sampler.torch_mapped()
    # at 4 workers every leg is a process (no copy legs)
    checks["clean_sampled_every_leg"] = len(legs) == len(dispatches)

    plan = "kill@0:1,corrupt@1:0,stop@1:0"
    rc, out, err, wall, sampler = run_sampled(
        ["supervise", g("G.dat"), "-w", str(workers), "-d", g("C"), "-o",
         g("T_chaos.tre"), "-v"], env={"SHEEP_FAULT_PLAN": plan})
    pre = _manifest_dispatches(g("C"))
    with open(g("C/manifest.json")) as f:
        pre_done = {leg["key"] for leg in json.load(f)["legs"]
                    if leg["state"] == "done"}
    fired = {"kill": re.search(r"^supervise: leg-failed r0\.01 exit status "
                               r"137$", out, re.M) is not None,
             "corrupt": re.search(r"^supervise: leg-failed r1\.00 fsck: ",
                                  out, re.M) is not None,
             "stop": re.search(r"^supervise: supervisor-killed r1\.00$",
                               out, re.M) is not None}
    rec["chaos"] = {"plan": plan, "killed_rc": rc, "killed_wall_s": wall,
                    "fired": fired, "done_before_resume": sorted(pre_done),
                    "dispatches_before_resume": pre,
                    "no_torch": not sampler.torch_mapped()}
    checks["chaos_supervisor_died"] = rc == 1
    checks["chaos_all_fired"] = all(fired.values())
    rc, out, err, wall, sampler = run_sampled(
        ["supervise", g("G.dat"), "-w", str(workers), "-d", g("C"), "-o",
         g("T_chaos.tre")])
    if rc != 0:
        raise AssertionError(f"supervise resume: exit {rc}\n{out}\n"
                             f"{err[-4000:]}")
    post = _manifest_dispatches(g("C"))
    redone = {k for k, n in post.items() if n > pre[k]}
    rec["chaos"].update(resume_wall_s=wall, dispatches_after_resume=post,
                        redispatched=sorted(redone),
                        by_kind=by_kind(sampler.legs()))
    checks["chaos_redispatched_only_unfinished"] = \
        redone == set(post) - pre_done
    checks["chaos_tree_identical"] = same_files(g("T_chaos.tre"),
                                                g("T_sup.tre"))
    checks["chaos_no_torch"] = (rec["chaos"]["no_torch"]
                                and not sampler.torch_mapped())

    out, wall, _ = run_tool("supervise", ["--status", "--json", "-d",
                                          g("S")])
    status = json.loads(out)
    rec["status"] = {"wall_s": wall, "done": status["done"],
                     "legs_done": status["legs_done"],
                     "legs_total": status["legs_total"],
                     "dispatches": status["dispatches"],
                     "state_dir_bytes": status["disk"]["state_dir_bytes"]}
    checks["status_json"] = (status["done"]
                             and status["legs_done"] == status["legs_total"]
                             == len(dispatches)
                             and status["dispatches"] == len(dispatches))
    for d in ("S", "C"):
        shutil.rmtree(g(d), ignore_errors=True)
    rec["checks"] = checks
    log("supervise " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"supervise: checks failed: {checks}")
    return rec


#: the reference's published distext deployment is DISTEXTBENCH r01
#: (DISTEXTBENCH_r01.json, scripts/distextbench.py): 2^25 R-MAT records
#: over 2^18 vertices, 4x a 96M per-leg budget, over 2 legs.  On the
#: card host a leg's interpreter, numpy and imports alone hold 88.6 MB of
#: RSS, leaving 12 MB of the 96 MiB where the reference's leg used about
#: 60 MB over its imports (PERF.md §4), so the phase keeps the factor of
#: 4 and the 2 legs at 192M a leg over 2^26 records: byte for byte the
#: ext phase's EXTBENCH file (log_n 20).  ``distext_phase(device,
#: log_n=18, records=1 << 25, budget="96M")`` runs the deployment as
#: published.
DISTEXT_BUDGET = "192M"
DISTEXT_LEGS = 2
#: the legs that fit their work to SHEEP_MEM_BUDGET (``cli/distext``'s
#: verbs), whose sampled peaks the bench's acceptance gates; the merge
#: legs are ``merge_trees``, which no budget prices in either package,
#: and their peaks are recorded beside
BUDGETED = ("hist", "distmap")


def distext_phase(device: torch.device, log_n: int = 20,
                  records: int = 1 << 26, budget: str = DISTEXT_BUDGET,
                  legs: int = DISTEXT_LEGS, dat: str | None = None,
                  keep: str | None = None) -> dict:
    """The distributed out-of-core build (``distext`` line), host code
    that loads no torch, at the reference's published deployment shape
    (a file 4x the per-leg budget over ``legs`` legs; DISTEXT_BUDGET):
    the bench's three arms and its acceptance, then a leg killed
    mid-range and the tight-budget auto-route.

    1. distext: ``graph2tree D.dat --distext -o D.tre`` as a process with
       SHEEP_DISTEXT_LEGS and SHEEP_MEM_BUDGET in its (and so every
       leg's) environment, its process tree sampled every 5 ms;
    2. ext: ``graph2tree D.dat --ext -o D_ext.tre`` under the same
       budget (PROC_WRAPPER's peak);
    3. oracle: ``graph2tree D.dat -o D_ram.tre``, in RAM, unbudgeted;
    the gates are the bench's: the file is 4x the per-leg budget, there
    are ``legs`` legs, every budgeted leg's sampled peak RSS (the hist and
    map legs; the bench gates its map legs) is inside the budget, and the
    distext tree equals the oracle's and the ext build's byte for byte;
    and torch is mapped into no process;
    4. the job again with map leg r0.00 killed (SIGKILL, from the
       sampler) once its first block checkpoint has landed: only that
       leg is re-dispatched, its second attempt resumes from the
       checkpoint (it folds fewer blocks than the range holds) and the
       tree is the same (SHEEP_FAULT_PLAN's ``kill`` fires at dispatch,
       before any block, so it cannot kill a leg mid-range);
    5. the tight-budget auto-route: ``graph2tree.main`` in this process,
       whose RSS is far past the budget, with no ``--distext`` and no
       leg count (SHEEP_LEG_CORES=4): the floor block cannot fit, the
       job goes to legs of their own, and the tree is the same.

    ``dat``: that file already written (the ext phase's EXTBENCH file,
    the same bytes ``write_extbench(log_n, records)`` writes).  ``keep``:
    a directory that gets copies of the distext and in-RAM trees
    (``D.tre``, ``D_ram.tre``) for the remote phase."""
    import signal

    from sheep_tpu_torch.cli import graph2tree
    from sheep_tpu_torch.resources.governor import parse_size

    budget_bytes = parse_size(budget)
    rec: dict = {"budget": budget, "budget_bytes": budget_bytes,
                 "legs": legs, "log_n": log_n}
    checks: dict = {}
    tmp = tempfile.mkdtemp(prefix="sheep-distext.")
    try:
        t = lambda name: os.path.join(tmp, name)
        if dat is None:
            rec["write_s"] = write_extbench(t("D.dat"), log_n=log_n,
                                            records=records)
        else:
            os.symlink(dat, t("D.dat"))
        rec["file_bytes"] = os.path.getsize(t("D.dat"))
        if rec["file_bytes"] != 12 * records:
            raise AssertionError(f"distext: {t('D.dat')} holds "
                                 f"{rec['file_bytes']} bytes, not "
                                 f"{records} records")
        rec["records"] = records
        # a leg's RSS before any work: the interpreter and numpy alone,
        # then with the leg tool's imports
        for key, mods in (("python_numpy_rss_bytes", "numpy"),
                          ("leg_import_rss_bytes",
                           "numpy, sheep_tpu_torch.cli.distext, "
                           "sheep_tpu_torch.cli.graph2tree, "
                           "sheep_tpu_torch.ops.extmem")):
            out = subprocess.run(
                [sys.executable, "-c", f"import {mods}\n"
                 "print(open('/proc/self/status').read())"],
                capture_output=True, text=True, cwd=ROOT, check=True).stdout
            rec[key] = int(re.search(r"^VmRSS:\s+(\d+) kB", out,
                                     re.M).group(1)) * 1024
        env = {"SHEEP_MEM_BUDGET": budget, "SHEEP_DISTEXT_LEGS": str(legs)}

        def distext_arm(name: str, watch=None) -> dict:
            rc, out, err, wall, sampler = run_sampled(
                ["graph2tree", t("D.dat"), "--distext", "-o",
                 t(f"{name}.tre")], env=env, watch=watch)
            state = t(f"{name}.tre.distext")
            if rc != 0:
                logs = os.path.join(state, "logs")
                tails = {n: open(os.path.join(logs, n)).read()[-800:]
                         for n in sorted(os.listdir(logs))}
                raise AssertionError(f"distext {name}: exit {rc}\n{out}\n"
                                     f"{err[-4000:]}\nlegs: {tails}")
            per_leg = {}
            for key in sorted(os.listdir(state)):
                if key.endswith(".perf.json"):
                    with open(os.path.join(state, key)) as f:
                        rep = json.load(f)
                    per_leg[key[:-len(".perf.json")]] = {
                        "range": rep["range"],
                        **{k: rep["perf"].get(k) for k in (
                            "read_s", "fold_s", "ext_blocks", "block_edges",
                            "strategies", "threads", "overlap_frac")},
                        "vmhwm": rep["proc_status"].get("vmhwm"),
                        "vmrss_at_exit": rep["proc_status"].get("vmrss")}
            legs_seen = sampler.legs()
            root = sampler.root_record()
            return {"wall_s": wall, "records_per_s": records / wall,
                    "dispatches": _manifest_dispatches(state),
                    "by_kind": by_kind(legs_seen), "per_leg": per_leg,
                    "legs_sampled": [{k: r[k] for k in (
                        "kind", "pid", "alive_s", "start_rss_bytes",
                        "peak_rss_bytes")} for r in legs_seen],
                    "parent_peak_rss_bytes": root["peak_rss_bytes"],
                    "leg_peaks_bytes": [r["peak_rss_bytes"]
                                        for r in legs_seen
                                        if r["kind"] in BUDGETED],
                    "merge_peaks_bytes": [r["peak_rss_bytes"]
                                          for r in legs_seen
                                          if r["kind"] == "merge"],
                    "no_torch": not sampler.torch_mapped()}

        arm = rec["distext"] = distext_arm("D")
        leg_peaks = arm["leg_peaks_bytes"]
        _, wall, proc = run_wrapped(
            "graph2tree", [t("D.dat"), "--ext", "-o", t("D_ext.tre")],
            env={"SHEEP_MEM_BUDGET": budget})
        rec["ext"] = {"wall_s": wall, "records_per_s": records / wall,
                      "peak_rss_bytes": proc["peak_rss_bytes"],
                      "start_rss_bytes": proc["start_rss_bytes"],
                      "torch_loaded": proc["torch_loaded"],
                      "ext_blocks": proc["ext_blocks"],
                      "strategies": proc["strategies"],
                      "perf": proc["perf"]}
        _, wall, proc = run_wrapped("graph2tree",
                                    [t("D.dat"), "-o", t("D_ram.tre")])
        rec["oracle"] = {"wall_s": wall, "records_per_s": records / wall,
                         "peak_rss_bytes": proc["peak_rss_bytes"],
                         "torch_loaded": proc["torch_loaded"]}
        rec["acceptance"] = {
            "file_ge_factor_x_leg_budget":
                rec["file_bytes"] >= 4 * budget_bytes,
            "n_legs_ge_2": len(arm["per_leg"]) == legs >= 2,
            "every_leg_rss_inside_budget":
                bool(leg_peaks) and max(leg_peaks) < budget_bytes,
            "distext_oracle_exact": same_files(t("D.tre"), t("D_ram.tre")),
            "distext_matches_single_host_ext": same_files(t("D.tre"),
                                                          t("D_ext.tre")),
        }
        checks.update(rec["acceptance"])
        checks["no_torch"] = (arm["no_torch"] and not rec["ext"]
                              ["torch_loaded"] and not rec["oracle"]
                              ["torch_loaded"])
        checks["each_leg_once"] = set(arm["dispatches"].values()) == {1}

        killed: dict = {}

        def kill_mid_range(sampler):
            # once the leg's first snapshot is published, and never while
            # it writes the next one: a kill between the sidecar's rename
            # and the snapshot's leaves a pair no resume accepts (both
            # packages; PERF.md §7)
            if killed:
                return
            ck = t("K.tre.distext/ck-r0.00")
            try:
                names = os.listdir(ck)
            except OSError:
                return
            if "sheep-ckpt.npz" not in names or any(
                    n.startswith(".sheep-ckpt.npz") for n in names):
                return
            for r in sampler.procs.values():
                if (f"-r 0:{records // legs} " in r["cmd"]
                        and "cli.distext map" in r["cmd"]):
                    try:
                        os.kill(r["pid"], signal.SIGKILL)
                    except ProcessLookupError:
                        continue  # an attempt that already ended
                    killed["pid"] = r["pid"]
                    killed["at_s"] = time.perf_counter() - sampler.t0
                    return

        arm = distext_arm("K", watch=kill_mid_range)
        leg0 = arm["per_leg"]["r0.00"]
        folded = sum((leg0["strategies"] or {}).values())
        rec["leg_kill"] = {"killed": killed, "wall_s": arm["wall_s"],
                           "dispatches": arm["dispatches"],
                           "resumed_leg": leg0,
                           "blocks_folded_after_resume": folded}
        checks["leg_kill_fired"] = bool(killed)
        checks["leg_kill_redispatched_only_it"] = arm["dispatches"] == {
            k: (2 if k == "r0.00" else 1) for k in arm["dispatches"]}
        checks["leg_kill_resumed_from_checkpoint"] = \
            0 < folded < leg0["ext_blocks"]
        checks["leg_kill_tree_identical"] = same_files(t("K.tre"),
                                                       t("D.tre"))

        auto_env = {"SHEEP_MEM_BUDGET": budget, "SHEEP_LEG_CORES": "4",
                    "SHEEP_DISTEXT_LEGS": None}
        with env_set(auto_env), TreeSampler(os.getpid()) as sampler:
            out, wall, _ = run_main(graph2tree, [t("D.dat"), "-o",
                                                 t("A.tre")], device=device)
        auto_legs = [r for r in sampler.legs() if r["kind"] in BUDGETED]
        merges = [r for r in sampler.legs() if r["kind"] == "merge"]
        rec["auto_route"] = {
            "wall_s": wall,
            "parent_rss_bytes": _status(os.getpid())["rss"],
            "dispatches": _manifest_dispatches(t("A.tre.distext")),
            "by_kind": by_kind(auto_legs + merges),
            "leg_peaks_bytes": [r["peak_rss_bytes"] for r in auto_legs],
            "merge_peaks_bytes": [r["peak_rss_bytes"] for r in merges]}
        checks["auto_route_took_distext"] = os.path.exists(
            t("A.tre.distext/manifest.json"))
        checks["auto_route_legs_inside_budget"] = bool(auto_legs) and max(
            r["peak_rss_bytes"] for r in auto_legs) < budget_bytes
        checks["auto_route_legs_no_torch"] = not any(
            r["torch_mapped"] for r in auto_legs + merges)
        checks["auto_route_sampled_legs"] = (
            {r["kind"] for r in auto_legs} == set(BUDGETED) and bool(merges))
        checks["auto_route_tree_identical"] = same_files(t("A.tre"),
                                                         t("D.tre"))
        if keep is not None:
            for name in ("D.tre", "D_ram.tre"):
                shutil.copyfile(t(name), os.path.join(keep, name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["checks"] = checks
    log("distext " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"distext: checks failed: {checks}")
    return rec


def _faqs(out: str) -> list:
    """The TREEFAQS block's lines of a tool's stdout."""
    lines = out.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith("TREEFAQS"))
    return lines[at:at + 5]


def jxn_phase(device: torch.device, log_n: int = 20, factor: int = 8,
              seed: int = 1):
    """The treewidth mode (``jxn`` line): hep-th ``graph2tree -k -e -j -f
    -c`` as a process (TREEFAQS width:551, ``Tree is valid.``, no torch)
    and ``-i -r -k -e -j -f -c`` in process, whose degree sort runs on
    the card (the same lines and the same .tre); then the reference's
    published configuration ``graph2tree R20.dat -k -e -j -w 64 -m 16384``
    on R-MAT 2^20 x 8 (``make_graph``), timed as a process, its tree
    equal to the port's insert in this process and valid under
    ``core.validate``."""
    import shutil
    import tempfile

    from sheep_tpu_torch.cli import graph2tree
    from sheep_tpu_torch.core import (JxnOptions, build_forest_jxn,
                                      degree_sequence, is_valid_forest)
    from sheep_tpu_torch.io import load_edges, read_tree

    hep = os.path.join(ROOT, "data", "hep-th.dat")
    rec: dict = {"hep": {}, "scale": {}}
    checks: dict = {}
    tmp = tempfile.mkdtemp(prefix="sheep-jxn.")
    try:
        t = lambda name: os.path.join(tmp, name)
        out, wall, proc = run_wrapped(
            "graph2tree", [hep, "-k", "-e", "-j", "-f", "-c", "-o",
                           t("J.tre")])
        faqs = _faqs(out)
        rec["hep"]["serial"] = {"wall_s": wall, "faqs": faqs,
                                "torch_loaded": proc["torch_loaded"]}
        checks["hep_serial_width_551"] = faqs[0].startswith(
            "TREEFAQS: width:551\t")
        checks["hep_serial_valid"] = "Tree is valid." in out
        checks["hep_serial_no_torch"] = not proc["torch_loaded"]
        out, wall, _ = run_main(graph2tree, [hep, "-i", "-r", "-k", "-e",
                                             "-j", "-f", "-c", "-o",
                                             t("J_ir.tre")], device=device)
        rec["hep"]["ir"] = {"wall_s": wall}
        checks["hep_ir_same_faqs"] = _faqs(out) == faqs
        checks["hep_ir_valid"] = "Tree is valid." in out
        checks["hep_ir_same_tree"] = same_files(t("J.tre"), t("J_ir.tre"))

        _, rec["scale"]["make_graph_s"], _ = run_tool(
            "make_graph", [str(log_n), str(factor), t("R.dat"), str(seed)])
        argv = [t("R.dat"), "-k", "-e", "-j", "-w", "64", "-m", "16384",
                "-f", "-o", t("RJ.tre")]
        out, wall, proc = run_wrapped("graph2tree", argv)
        faqs = _faqs(out)
        width = int(re.search(r"width:(\d+)", faqs[0]).group(1))
        fill = int(re.search(r"fill:(\d+)", faqs[4]).group(1))
        rec["scale"].update(wall_s=wall, max_width=width, fill=fill,
                            peak_rss_bytes=proc["peak_rss_bytes"],
                            torch_loaded=proc["torch_loaded"],
                            phases=[ln for ln in out.splitlines()
                                    if " in: " in ln])
        el = load_edges(t("R.dat"))
        opts = JxnOptions(make_kids=True, make_pst=True, make_jxn=True,
                          width_limit=64, memory_limit=16384 << 20)
        forest, eseq, widths = build_forest_jxn(
            el.tail, el.head, degree_sequence(el.tail, el.head), opts)
        parent, pst = read_tree(t("RJ.tre"))
        checks["scale_tree_equals_insert"] = (
            np.array_equal(parent, forest.parent)
            and np.array_equal(pst, forest.pst_weight))
        checks["scale_width"] = int(widths.max()) == width
        checks["scale_valid"] = bool(is_valid_forest(
            forest, el.tail, el.head, eseq, max_vid=el.max_vid))
        checks["scale_no_torch"] = not proc["torch_loaded"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["checks"] = checks
    log("jxn " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"jxn: checks failed: {checks}")
    return rec



#: an analysis tool started as the ``util/`` shims start the reference's
TOOL_SHIM = ("import sys; from sheep_tpu_torch.cli.tools import {tool}; "
             "sys.exit({tool}())")


def run_shim(tool: str, argv: list) -> tuple:
    """One analysis tool as a process from the checkout's root, its tree
    sampled; returns (stdout, its record: wall, peak RSS, torch
    mapped)."""
    rc, out, err, wall, sampler = run_cmd_sampled(
        [sys.executable, "-c", TOOL_SHIM.format(tool=tool)] + argv,
        timeout=600)
    if rc != 0:
        raise AssertionError(f"tools: {tool} {' '.join(argv)} exited "
                             f"{rc}:\n{out}\n{err[-4000:]}")
    peak = max(r["peak_rss_bytes"] for r in sampler.procs.values())
    return out, {"wall_s": wall, "peak_rss_bytes": peak,
                 "torch_mapped": sampler.torch_mapped()}


def write_jparts(tre: str, parts: int, path: str) -> None:
    """A ``parts``-part jnid partition of the tree, as the text file
    ``read_partition`` reads."""
    from sheep_tpu_torch.core.forest import Forest
    from sheep_tpu_torch.io import read_tree
    from sheep_tpu_torch.partition import partition_forest
    parent, pst = read_tree(tre)
    jparts = partition_forest(Forest(parent, pst), parts)
    with open(path, "w") as f:
        f.write("\n".join(map(str, jparts.tolist())) + "\n")


def tools_phase(gdir: str, part_rec: dict) -> dict:
    """The six analysis tools (``tools`` line), each a process started as
    the ``util/`` shims start the reference's: on hep-th (the golden
    lines: ECV(down) 521, 2811 edges cut, sizes 3409/4201), then
    ``vfennel``, ``efennel`` and ``read_partition`` on the ``cli``
    phase's 2^23 x 8 G.dat (read_partition's report equal to the
    partition phase's at 2 parts); each one's wall and peak RSS, and
    torch mapped into none."""
    from sheep_tpu_torch.io import read_sequence
    from sheep_tpu_torch.partition import Partition

    hep = os.path.join(ROOT, "data", "hep-th.dat")
    tdir = os.path.join(gdir, "tools")
    os.makedirs(tdir)

    def t(name):
        return os.path.join(tdir, name)
    run_tool("degree_sequence", [hep, t("hep.seq")])
    run_tool("graph2tree", [hep, "-s", t("hep.seq"), "-o", t("hep.tre")])
    write_jparts(t("hep.tre"), 2, t("hep.part"))
    rec, checks, outs = {"hep": {}, "real": {}}, {}, {}
    for tool, argv in (("tree2dot", [t("hep.tre"), t("hep.dot")]),
                       ("tree2adj", [t("hep.tre"), t("hep.adj")]),
                       ("graph2adj", [hep, t("hepg.adj")]),
                       ("vfennel", [hep, "2"]), ("efennel", [hep, "2"]),
                       ("read_partition", [hep, t("hep.part")])):
        outs[tool], rec["hep"][tool] = run_shim(tool, argv)
    with open(t("hep.dot")) as f:
        dot = f.read().splitlines()
    checks["hep_tree2dot"] = (dot[0] == "digraph {" and dot[-1] == "}"
                              and len(dot) == 7612)
    with open(t("hep.adj")) as f:
        checks["hep_tree2adj"] = f.readline().split() == ["7610", "7029",
                                                          "011"]
    with open(t("hepg.adj")) as f:
        checks["hep_graph2adj"] = f.readline().split() == ["7610", "15751",
                                                           "010"]
    checks["hep_vfennel"] = ("Actually created 2 partitions." in
                             outs["vfennel"]
                             and "ECV(down)" not in outs["vfennel"])
    checks["hep_efennel"] = "Actually created 2 partitions." in \
        outs["efennel"]
    part = Partition.from_file(read_sequence(t("hep.seq")), t("hep.part"))
    sizes = np.bincount(part.parts[part.parts >= 0]).tolist()
    checks["hep_read_partition"] = (
        all(ln in outs["read_partition"]
            for ln in ("ECV(down): 521 ", "edges cut: 2811 ",
                       "balance: 4201 "))
        and sizes == [3409, 4201])

    g = os.path.join(gdir, "G.dat")
    _, rec["real"]["write_partition_s"] = timed_call(
        lambda: write_jparts(os.path.join(gdir, "T.tre"), 2, t("G.part")))
    for tool, argv in (("vfennel", [g, "2"]), ("efennel", [g, "2"]),
                       ("read_partition", [g, t("G.part")])):
        outs[tool], rec["real"][tool] = run_shim(tool, argv)
    want = next(r for r in part_rec["real"] if r["parts"] == 2)
    checks["real_vfennel"] = "Actually created 2 partitions." in \
        outs["vfennel"]
    checks["real_efennel"] = "Actually created 2 partitions." in \
        outs["efennel"]
    # the tool's in-memory report, line for line the streamed one's
    lines = outs["read_partition"].splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("edges cut"))
    report = lines[start:start + len(want["report"])]
    checks["real_read_partition"] = report == want["report"]
    rec["real"]["read_partition_report"] = report
    checks["no_torch"] = not any(r["torch_mapped"]
                                 for side in ("hep", "real")
                                 for r in rec[side].values()
                                 if isinstance(r, dict))
    rec["checks"] = checks
    shutil.rmtree(tdir, ignore_errors=True)
    log("tools " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"tools: checks failed: {checks}")
    return rec


#: the re-sequence and ECV steps of the serve phase run on a store over
#: ``make_graph SERVE_RESEQ_LOG_N 8``: two folds over the real-size 2^26
#: records do not fit the phase's share of the script's time (PERF.md §4)
SERVE_RESEQ_LOG_N = 20


def serve_phase(gdir: str, work: str, **sizes) -> dict:
    """The serve store at real size (``serve`` line), in a child process
    that never loads torch (``python -m
    sheep_tpu_torch.scripts.serve_drive run``): bootstrapped on the
    ``cli`` phase's T.tre/S2.seq, which ``graph2tree -i -r`` built on the
    card through K1, with G.dat as the graph; 2^16 inserts in batches of
    64 from 4 threads beside part and subtree queries, killed at the
    512th insert and recovered (no acknowledged insert lost, the state
    equal to a replay of the log); a re-sequence against the host
    oracle, and one killed at its fold and resumed, equal to it; ECV
    against the evaluator; fsck of the state dirs and of a flipped WAL.
    Its process tree is sampled (peak RSS, torch mapped into none).
    The re-sequence and ECV steps run at SERVE_RESEQ_LOG_N."""
    argv = [sys.executable, "-m", "sheep_tpu_torch.scripts.serve_drive",
            "run", work, "--tree", os.path.join(gdir, "T.tre"),
            "--seq", os.path.join(gdir, "S2.seq"),
            "--graph", os.path.join(gdir, "G.dat")]
    for k, v in sizes.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    cut = os.path.join(gdir, f"G{SERVE_RESEQ_LOG_N}.dat")
    run_tool("make_graph", [str(SERVE_RESEQ_LOG_N), "8", cut, "0"])
    argv += ["--reseq-graph", cut, "--reseq-log-n", str(SERVE_RESEQ_LOG_N)]
    rc, out, err, wall, sampler = run_cmd_sampled(argv, timeout=900)
    found = [ln for ln in out.splitlines() if ln.startswith("serve_record ")]
    if rc != 0 or not found:
        raise AssertionError(f"serve: the drive exited {rc}:\n{out[-4000:]}"
                             f"\n{err[-4000:]}")
    rec = json.loads(found[-1].split(" ", 1)[1])
    rec["wall_s"] = wall
    rec["peak_rss_bytes"] = max(r["peak_rss_bytes"]
                                for r in sampler.procs.values())
    rec["torch_mapped"] = sampler.torch_mapped()
    rec["processes"] = len(sampler.procs)
    rec["traces"] = [os.path.join(work, "traces", name)
                     for name in ("killed.trace", "restart.trace")]
    log("serve " + json.dumps(rec))
    if rec["torch_mapped"] or not all(rec["checks"].values()):
        raise AssertionError(f"serve: checks failed: {rec['checks']}, "
                             f"torch mapped: {rec['torch_mapped']}")
    return rec


def _proc_rows(sampler, tag: str) -> list:
    """Each sampled process whose command line names ``tag``: its pid,
    ``--node-id`` (or the command's last word), seconds alive and peak
    RSS."""
    rows = []
    for r in sorted(sampler.procs.values(), key=lambda r: r["first_s"]):
        if tag not in r["cmd"]:
            continue
        words = r["cmd"].split()
        name = words[words.index("--node-id") + 1] \
            if "--node-id" in words else os.path.basename(words[-1])
        rows.append({"name": name, "pid": r["pid"],
                     "alive_s": r["last_s"] - r["first_s"],
                     "peak_rss_bytes": r["peak_rss_bytes"],
                     "torch_mapped": r["torch_mapped"]})
    return rows


def daemon_phase(serve_work: str, **sizes) -> dict:
    """The serve daemon as a replicated cluster at real size (``daemon``
    line): ``python -m sheep_tpu_torch.scripts.daemon_drive run`` in a
    child process that never loads torch, its process tree sampled, on
    the serve phase's recovered 2^23 store (``serve_work/sd``, whose
    snapshot names G.dat, so it runs while the graph dir is kept) with
    its 2^20 store (``serve_work/sd_cut``) as the second tenant.  Each
    node's peak RSS comes from the sampler."""
    argv = [sys.executable, "-m", "sheep_tpu_torch.scripts.daemon_drive",
            "run", os.path.join(serve_work, "cluster"),
            "--state", os.path.join(serve_work, "sd"),
            "--tenant-dir", os.path.join(serve_work, "sd_cut"),
            "--tenant-log-n", str(SERVE_RESEQ_LOG_N)]
    for k, v in sizes.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    rc, out, err, wall, sampler = run_cmd_sampled(argv, timeout=900)
    found = [ln for ln in out.splitlines() if ln.startswith("daemon_record ")]
    if rc != 0 or not found:
        raise AssertionError(f"daemon: the drive exited {rc}:\n{out[-4000:]}"
                             f"\n{err[-6000:]}")
    rec = json.loads(found[-1].split(" ", 1)[1])
    rec["wall_s"] = wall
    rec["nodes"] = _proc_rows(sampler, "sheep_tpu_torch.cli.serve")
    rec["driver_peak_rss_bytes"] = sampler.root_record()["peak_rss_bytes"]
    rec["torch_mapped"] = sampler.torch_mapped()
    rec["processes"] = len(sampler.procs)
    log("daemon " + json.dumps(rec))
    if rec["torch_mapped"] or not all(rec["checks"].values()):
        raise AssertionError(f"daemon: checks failed: {rec['checks']}, "
                             f"torch mapped: {rec['torch_mapped']}")
    return rec


def fleet_phase(serve_work: str) -> dict:
    """The routed fleet at real size (``fleet`` line): ``python -m
    sheep_tpu_torch.scripts.fleet_drive run`` in a child process that
    never loads torch, its process tree sampled, with the serve phase's
    2^23 store (``serve_work/sd``, after the daemon phase's processes
    exited) as the hot tenant in place and copies of its 2^20 store
    (``serve_work/sd_cut``) as the others; the snapshots name the graph
    dir's files, so it runs while that dir is kept.  Each process's peak
    RSS comes from the sampler."""
    argv = [sys.executable, "-m", "sheep_tpu_torch.scripts.fleet_drive",
            "run", os.path.join(serve_work, "fleet"),
            "--hot", os.path.join(serve_work, "sd"),
            "--cut", os.path.join(serve_work, "sd_cut")]
    rc, out, err, wall, sampler = run_cmd_sampled(argv, timeout=900)
    found = [ln for ln in out.splitlines() if ln.startswith("fleet_record ")]
    if rc != 0 or not found:
        raise AssertionError(f"fleet: the drive exited {rc}:\n{out[-4000:]}"
                             f"\n{err[-6000:]}")
    rec = json.loads(found[-1].split(" ", 1)[1])
    rec["wall_s"] = wall
    rec["nodes"] = _proc_rows(sampler, "sheep_tpu_torch.cli.serve")
    rec["routers"] = [dict(r, name="router") for r in
                      _proc_rows(sampler, "sheep_tpu_torch.cli.route")]
    rec["driver_peak_rss_bytes"] = sampler.root_record()["peak_rss_bytes"]
    rec["torch_mapped"] = sampler.torch_mapped()
    rec["processes"] = len(sampler.procs)
    log("fleet " + json.dumps(rec))
    if rec["torch_mapped"] or not all(rec["checks"].values()):
        raise AssertionError(f"fleet: checks failed: {rec['checks']}, "
                             f"torch mapped: {rec['torch_mapped']}")
    return rec


def remote_phase(gdir: str, distext_rec: dict) -> dict:
    """The remote build workers at real size (``remote`` line):
    ``python -m sheep_tpu_torch.scripts.remote_drive run`` in a child
    process, its process tree sampled, on the distext phase's file (the
    ext phase's EXTBENCH E.dat, 2^26 records over 2^20 vertices) at its
    budget and leg count, its tree held to the distext phase's tree and
    in-RAM oracle (``D.tre``, ``D_ram.tre`` kept in ``gdir``)."""
    tmp = tempfile.mkdtemp(prefix="sheep-remote.")
    try:
        argv = [sys.executable, "-m", "sheep_tpu_torch.scripts.remote_drive",
                "run", os.path.join(tmp, "work"),
                "--graph", os.path.join(gdir, "E.dat"),
                "--want", os.path.join(gdir, "D.tre"),
                "--oracle", os.path.join(gdir, "D_ram.tre"),
                "--budget", DISTEXT_BUDGET, "--legs", str(DISTEXT_LEGS)]
        rc, out, err, wall, sampler = run_cmd_sampled(argv, timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = [ln for ln in out.splitlines() if ln.startswith("remote_record ")]
    if rc != 0 or not found:
        raise AssertionError(f"remote: the drive exited {rc}:\n{out[-4000:]}"
                             f"\n{err[-6000:]}")
    rec = json.loads(found[-1].split(" ", 1)[1])
    rec["wall_s"] = wall
    rec["local_distext_wall_s"] = distext_rec["distext"]["wall_s"]
    rec["workers"] = _proc_rows(sampler, "sheep_tpu_torch.cli.worker")
    rec["budget_bytes"] = distext_rec["budget_bytes"]
    rec["supervisors"] = _proc_rows(sampler, "cli.graph2tree")
    rec["torch_mapped"] = sampler.torch_mapped()
    log("remote " + json.dumps(rec))
    if rec["torch_mapped"] or not all(rec["checks"].values()):
        raise AssertionError(f"remote: checks failed: {rec['checks']}, "
                             f"torch mapped: {rec['torch_mapped']}")
    return rec


def trace_phase(build_trace: str, serve_rec: dict) -> dict:
    """The ``trace`` tool (``trace`` line), as processes: on the
    real-size resilient build's trace, whose rung explanation must name
    the plan and every rung the build's events record (and ``--json``
    the same lines); then ``--merge`` of the serve phase's two store
    processes (the killed one and its restart), in which the killed
    request's id must join records of both."""
    from sheep_tpu_torch.obs.trace import read_trace

    def run(argv):
        out, wall, _ = run_tool("trace", argv)
        return out, wall

    rec, checks = {}, {}
    out, rec["explain_s"] = run([build_trace])
    records, _, _ = read_trace(build_trace, "strict")
    evs = [r for r in records if r["k"] == "ev"]
    ran = [r["a"]["rung"] for r in evs if r["name"] == "rung.ok"]
    plans = [r["a"]["rungs"] for r in evs if r["name"] == "ladder.plan"]
    checks["names_every_rung_run"] = bool(ran) and all(
        f"ran: rung '{r}'" in out for r in ran)
    checks["names_the_plan"] = bool(plans) and all(
        f"ladder plan: {' -> '.join(p)}" in out for p in plans)
    js, _ = run(["--json", build_trace])
    ladder = json.loads(js)["ladder"]
    checks["json_same_ladder"] = all(ln in out for ln in ladder)
    rec["ran"], rec["ladder"] = ran, ladder
    out, rec["merge_s"] = run(["--merge", "--json", *serve_rec["traces"]])
    merged = json.loads(out)
    labels = [f["label"] for f in merged["files"]]
    rid = serve_rec["kill_rid"]
    srcs = sorted({r["src"] for r in merged["rids"].get(rid, [])})
    checks["kill_rid_in_both"] = len(labels) == 2 and srcs == sorted(labels)
    file_rids = []
    for path in serve_rec["traces"]:
        recs, _, _ = read_trace(path, "repair")
        file_rids.append({r["rid"] for r in recs if "rid" in r})
    checks["merged_rids_are_the_files"] = \
        set(merged["rids"]) == file_rids[0] | file_rids[1]
    rec["rids"] = {"merged": len(merged["rids"]), "killed": len(file_rids[0]),
                   "restart": len(file_rids[1]),
                   "both": len(file_rids[0] & file_rids[1])}
    rec["files"] = merged["files"]
    out, _ = run(["--merge", "--rid", rid, *serve_rec["traces"]])
    checks["merge_renders_the_rid"] = rid in out
    rec["checks"] = checks
    log("trace " + json.dumps(rec))
    if not all(checks.values()):
        raise AssertionError(f"trace: checks failed: {checks}")
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


def resilient_real(device, data, hybrid_wall: float,
                   keep_trace: str | None = None):
    """The fault-tolerant build at real size on the card: equal to the
    oracle, no degrade, K1 launched on the single rung; its wall beside
    the streamed hybrid's, and its parts from the build's own trace
    (SHEEP_TRACE: the prep and rung spans, the dispatch spans), from
    :class:`SaveRecorder` (each snapshot's seconds and bytes) and from
    :class:`LoopRecorder` (the loop's device waits, boundary fetches,
    host assists and remaps).  ``keep_trace``: where to copy the
    build's trace for the ``trace`` phase."""
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
        if keep_trace is not None:
            shutil.copyfile(path, keep_trace)
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


#: the ladder of the mesh phase's resilient run: the mesh rung first
MESH_LADDER = ("mesh", "single", "host", "stream", "spill")


@contextlib.contextmanager
def mesh_workers(device: torch.device, w: int):
    """Give the port's mesh ``w`` workers on ``device`` inside the block,
    through the seam ``parallel.mesh.mesh_devices`` (one card here: the
    workers share it and run their rounds in turn)."""
    from sheep_tpu_torch.parallel import mesh

    saved = mesh.mesh_devices
    mesh.mesh_devices = lambda dev: [device] * w
    try:
        yield
    finally:
        mesh.mesh_devices = saved


def mesh_run(name: str, w: int, build, want_seq, want, device,
             check=None) -> dict:
    """One mesh build of ``w`` workers on the card: ``build(timings,
    comm)`` returns (seq, Forest), which must equal the oracle (``check``
    replaces the comparison where the result is not one tree); K1 must be
    launched, and on every worker where the build reports per-worker
    launches.  Returns the run's record: wall, timings, comm, launches,
    peak device memory, and the host-clock seconds of the single-device
    loop's plateau assists and vertex remaps (:class:`LoopRecorder`; the
    replicated finish of the gathered tail runs that loop)."""
    tm: dict = {}
    comm: dict = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with mesh_workers(device, w), LoopRecorder() as loop:
        out, wall, launches = counted_build(lambda: build(tm, comm), name)
    ok = check(out) if check is not None else forest_equal(*out, want_seq,
                                                           want)
    if not ok:
        raise AssertionError(f"mesh {name} (W={w}) differs from the oracle")
    parts = loop.record()
    rec = {"run": name, "W": w, "wall_s": wall, "k1_launches": launches,
           **{k: parts[k] for k in ("assist_s", "assist_calls", "remap_s",
                                    "remap_calls")}}
    if tm:
        rec["timings"] = {k: tm[k] for k in ("prep_s", "map_s", "reduce_s",
                                             "map_rounds", "reduce_rounds")}
        rec["k1_by_worker"] = tm["k1_by_worker"]
        if min(tm["k1_by_worker"]) <= 0:
            raise AssertionError(f"mesh {name} (W={w}): K1 was not launched "
                                 f"on every worker: {tm['k1_by_worker']}")
    if comm:
        rec["comm"] = comm
    if device.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"mesh run {json.dumps(rec)}")
    return rec


MESH_G2T = """\
import sys
import torch
from sheep_tpu_torch.cli import graph2tree
from sheep_tpu_torch.ops import fused_jump
from sheep_tpu_torch.parallel import mesh
workers = int(sys.argv.pop(1))
mesh.mesh_devices = lambda dev: [torch.device("cuda", 0)] * workers
rc = graph2tree.main(sys.argv[1:])
import torch.distributed as dist
print("mesh_job", dist.get_backend(), dist.get_world_size(),
      fused_jump.launches, file=sys.stderr)
dist.destroy_process_group()
sys.exit(rc)
"""


def mesh_nccl_cli(device: torch.device, workers: int = 2) -> dict:
    """``graph2tree data/hep-th.dat -i -r -f -c`` as a process joined
    through SHEEP_COORDINATOR at world size 1 (NCCL), with ``workers``
    mesh workers on the card: the golden TREEFAQS line, ``Tree is
    valid.``, the NCCL backend and K1 launched in the process."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    env = dict(os.environ, SHEEP_COORDINATOR=coord, SHEEP_NUM_PROCESSES="1",
               SHEEP_PROCESS_ID="0", SHEEP_WORKERS=str(workers))
    hep = os.path.join(ROOT, "data", "hep-th.dat")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", MESH_G2T, str(workers), hep, "-i", "-r",
         "-f", "-c"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"mesh: graph2tree under SHEEP_COORDINATOR "
                             f"exited {proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    found = re.findall(r"^mesh_job (\S+) (\d+) (\d+)$", proc.stderr, re.M)
    backend, world, launches = found[-1][0], int(found[-1][1]), \
        int(found[-1][2])
    faqs = proc.stdout[proc.stdout.index("TREEFAQS"):].split(
        "Tree is")[0] if "TREEFAQS" in proc.stdout else ""
    rec = {"run": "graph2tree -i -r (SHEEP_COORDINATOR, world size 1)",
           "W": workers, "backend": backend, "world_size": world,
           "wall_s": wall, "k1_launches": launches,
           "golden": faqs == GOLDEN_TREEFAQS,
           "valid": "Tree is valid." in proc.stdout}
    log(f"mesh run {json.dumps(rec)}")
    if backend != "nccl" or world != 1 or launches <= 0 \
            or not rec["golden"] or not rec["valid"]:
        raise AssertionError(f"mesh: the NCCL job failed its checks: {rec}")
    return rec


def mesh_phase(device: torch.device, real, small, widths=(2, 4, 8),
               blocks: int = 4, full: dict | None = None) -> dict:
    """The sharded mesh build (``parallel/``) on one card, its workers on
    the card through the ``mesh_devices`` seam, every run equal to the
    oracle bit for bit: on ``real`` ``build_graph_distributed`` at each
    of ``widths`` (chunked, unified), the split form and the map-only
    partials (merged by ``merge_forests_device``) at W = 4, and the
    resilient build from its mesh rung at W = 4 (checkpoints on, no
    fault); on ``small`` the single-dispatch twin (SHEEP_MESH_KERNEL=loop)
    and both mesh streaming builds in ``blocks`` blocks at W = 4; then
    ``graph2tree -i -r`` joined at world size 1 over NCCL.  ``full``: a
    larger input (and its oracle) for some widths, by width.  Prints one
    ``mesh`` line."""
    from sheep_tpu_torch.core.sequence import sequence_positions
    from sheep_tpu_torch.ops.forest import merge_forests_device
    from sheep_tpu_torch.parallel import (build_graph_chunked_distributed,
                                          build_graph_distributed,
                                          build_graph_streaming_chunked,
                                          build_graph_streaming_sharded,
                                          map_graph_distributed)

    t_phase = time.perf_counter()
    tail, head, want_seq, want = real
    runs = []
    for w in widths:
        t, h, ws, wf = (full or {}).get(w, real)
        runs.append(mesh_run(
            "build_graph_distributed", w,
            lambda tm, comm, w=w, t=t, h=h: build_graph_distributed(
                t, h, num_workers=w, device=device, timings=tm,
                comm=comm), ws, wf, device))
        runs[-1]["records"] = len(t)
        del t, h, ws, wf
    runs.append(mesh_run(
        "build_graph_chunked_distributed(unified=False)", 4,
        lambda tm, comm: build_graph_chunked_distributed(
            tail, head, num_workers=4, device=device, timings=tm, comm=comm,
            unified=False), want_seq, want, device))
    merged = {}

    def map_then_merge(tm, comm):
        seq, parts = map_graph_distributed(tail, head, num_workers=4,
                                           device=device)
        t0 = time.perf_counter()
        merged["forest"] = merge_forests_device(*parts, device=device)
        merged["merge_s"] = time.perf_counter() - t0
        merged["partials"] = len(parts)
        return seq, parts

    rec = mesh_run("map_graph_distributed + merge_forests_device", 4,
                   map_then_merge, want_seq, want, device,
                   check=lambda out: len(out[1]) == 4 and forest_equal(
                       out[0], merged["forest"], want_seq, want))
    rec["merge_s"] = merged["merge_s"]
    runs.append(rec)
    with tempfile.TemporaryDirectory(prefix="sheep-mesh.") as tmp:
        cfgs = []

        def resilient(tm, comm):
            seq, forest, cfg = resilient_run(tail, head, device,
                                             os.path.join(tmp, "ckpt"),
                                             ladder=MESH_LADDER)
            cfgs.append(cfg)
            return seq, forest

        rec = mesh_run("build_graph_resilient (mesh rung)", 4, resilient,
                       want_seq, want, device)
    kinds = event_kinds(cfgs[0])
    ran = [e[1] for e in cfgs[0].events if e[0] == "checkpoint"]
    if "degrade" in kinds or not ran or ran[-1] not in ("mesh",):
        raise AssertionError(f"mesh: the resilient build left the mesh rung "
                             f"with no fault: {cfgs[0].events}")
    rec["events"] = kinds
    runs.append(rec)
    tail, head, want_seq, want = small
    with env_set({"SHEEP_MESH_KERNEL": "loop"}):
        runs.append(mesh_run(
            "build_graph_distributed (SHEEP_MESH_KERNEL=loop)", 4,
            lambda tm, comm: build_graph_distributed(
                tail, head, num_workers=4, device=device), want_seq, want,
            device))
    m = len(want_seq)
    pos = sequence_positions(want_seq, int(max(tail.max(), head.max())))
    block = -(-len(tail) // blocks)
    for name, fn in (("build_graph_streaming_sharded",
                      build_graph_streaming_sharded),
                     ("build_graph_streaming_chunked",
                      build_graph_streaming_chunked)):
        rounds = {}

        def stream(tm, comm, fn=fn):
            forest, rounds["total"] = fn(_blocks(tail, head, block), m, pos,
                                         block, num_workers=4,
                                         device=device)
            return want_seq, forest

        rec = mesh_run(name, 4, stream, want_seq, want, device)
        rec.update(blocks=blocks, total_rounds=rounds["total"])
        runs.append(rec)
    runs.append(mesh_nccl_cli(device))
    out = {"phase_s": time.perf_counter() - t_phase, "runs": runs}
    log("mesh " + json.dumps(out))
    return out


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
    fetch_phase(device)
    small_data = real_inputs(20, 23, 1)
    streaming_phase(device, real_data, small_data)
    part_rec = partition_phase(device, real_data, small_data)
    gdir = tempfile.mkdtemp(prefix="sheep-real.")
    keep = tempfile.mkdtemp(prefix="sheep-traces.")
    try:
        try:
            cli_phase(device, real_data, part_rec, keep=gdir)
            ext_phase(device, real_data, gdir)
            supervise_phase(real_data, gdir)
            dist_rec = distext_phase(device, dat=os.path.join(gdir, "E.dat"),
                                     keep=gdir)
            remote_phase(gdir, dist_rec)
            tools_phase(gdir, part_rec)
            serve_rec = serve_phase(gdir, os.path.join(keep, "serve"))
            daemon_phase(os.path.join(keep, "serve"))
            fleet_phase(os.path.join(keep, "serve"))
        finally:
            shutil.rmtree(gdir, ignore_errors=True)
        # the default tail's last run (the runs in between are other arms)
        main_run = next(r for r in reversed(real) if r["arm"] == "stream")
        build_trace = os.path.join(keep, "build.trace")
        resilient_real(device, real_data, main_run["wall_s"],
                       keep_trace=build_trace)
        trace_phase(build_trace, serve_rec)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # the mesh phase at 2^22 x 8 but for W = 2 at real size (where the
    # finish's plateau assist is tracked) keeps the script inside its
    # time limit on the slowest card host seen (PERF.md §4)
    mesh_data = real_inputs(22, 25, 0)
    mesh = mesh_phase(device, mesh_data, small_data, full={2: real_data})
    del mesh_data
    del real_data
    device_phase(device, small_data)
    resilient_faults(device, small_data)
    jxn_phase(device)
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
        # the mesh phase's launches, run by run
        "mesh_launches": {f"{r['run']} W={r['W']}": r["k1_launches"]
                          for r in mesh["runs"]},
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
