"""The mesh-sharded chunked build: the bounded-dispatch reduce loop over
the worker mesh (port of sheep_tpu/parallel/chunked.py; the design and
its soundness argument are in that module's docstring).

Two round flavours compose the reference's map/reduce split
(lib/jnode.cpp:203-250):

  local rounds  (map)    each worker reduces its own shard's links against
                         its own min-up table, with no communication;
                         converged shards hold per-worker partial forests
                         over the shared sequence.
  global rounds (reduce) the same round, but the jump table is the minimum
                         of the workers' tables across the mesh (one
                         [n+1] ``pmin`` a round), taken BEFORE the lifting
                         descent, so every worker descends through the
                         same global table.

Once the live window is cheaper to move than a few more table reduces,
the links gather once (the gather-tail) and, with the sharded tail, are
re-split by contiguous hi window, collapsed by local rounds on each
worker, gathered again and finished by the single-device loop
(``ops.forest.reduce_links_hosted``).

Each round's per-worker part runs for each worker of the mesh in turn;
on CUDA each worker's descent launches kernel K1 (``ops.forest.
_lift_descend``), and ``Mesh.k1_launches`` tallies them per worker.  The
replicated computations run once per process on the mesh's ``home``
device: the degree sort, the window bounds' sort, the gathered tail's
finish and the parent extraction of gathered links.  Round counts,
compaction, the depth tiers, the gather and tail-shard decisions and the
collective-volume model ``comm`` are the reference's, so they come out
equal.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import INVALID_JNID, resolve_device
from ..core.forest import Forest
from ..obs import trace as obs
from ..ops import fused_jump
from ..ops.forest import (_CHUNK_SCHEDULE as _SCHEDULE, _depth_tier,
                          _lift_descend, _rewrite_sorted, min_up_table,
                          parent_from_links, pst_weights, sort_links)
from .build import _degree_order_sharded, _fetch, _given_order, _to_forest
from .mesh import Mesh, make_mesh

_JROUNDS = 8
_LEVELS = 10
_FIRST_LEVELS = 4


def _sync(mesh: Mesh) -> None:
    """Wait for the mesh's queued device work (timings only)."""
    for d in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _i32(xs: list) -> list:
    return [x.to(torch.int32) for x in xs]


def chunk_sharded(lo: list, hi: list, n: int, mesh: Mesh, levels: int,
                  jrounds: int, global_f: bool):
    """``jrounds`` rounds on the workers' [B] link rows.  A round on each
    worker: sort, live count, star -> chain rewrite, min-up table f; for
    global rounds the tables' minimum across the mesh; then the lifting
    descent through f (K1 on CUDA).  Returns (lo, hi, stats) with stats
    int32 [2] = (moved over the mesh, max live of a row) of the last
    round, replicated: one host fetch a chunk."""
    lo, hi = _i32(lo), _i32(hi)
    k = len(lo)
    moved = [torch.zeros((), dtype=torch.int32, device=x.device)
             for x in lo]
    live = [torch.full((), x.shape[0], dtype=torch.int32, device=x.device)
            for x in lo]
    for _ in range(jrounds):
        fs, rewrites = [], []
        for i in range(k):
            lo[i], hi[i] = sort_links(lo[i], hi[i])
            live[i] = (lo[i] != n).sum(dtype=torch.int32)
            lo[i], hi[i], rw = _rewrite_sorted(lo[i], hi[i], n)
            rewrites.append(rw)
            fs.append(min_up_table(lo[i], hi[i], n))
        if global_f:
            fs = mesh.scatter(mesh.pmin(fs))
        for i in range(k):
            before = fused_jump.launches
            lo[i], jumped = _lift_descend(lo[i], hi[i], n, levels, fs[i],
                                          sorted_links=True)
            mesh.k1_launches[i] += fused_jump.launches - before
            moved[i] = rewrites[i] + jumped
    stats = torch.stack([mesh.psum(moved), mesh.pmax(live)])
    return lo, hi, stats


def parent_sharded_local(lo: list, hi: list, n: int, mesh: Mesh):
    """Per-worker parent extraction from converged shards, stacked [W, n]
    with no combine: row i is worker i's partial forest over the shared
    sequence (the `-i`-without-`-r` map phase)."""
    return mesh.all_gather([parent_from_links(l, h, n)
                            for l, h in zip(lo, hi)])


def parent_sharded(lo: list, hi: list, n: int, mesh: Mesh):
    """Global parent extraction from converged sharded links: the
    workers' scatter-min tables combined by ``pmin`` (valid once their
    union forms a forest)."""
    return mesh.pmin([min_up_table(l, h, n) for l, h in zip(lo, hi)])[:n]


def prep_sharded(tail: list, head: list, n: int, mesh: Mesh, pos=None,
                 with_pos: bool = False, local_pst: bool = False):
    """Degree sort and link mapping over the mesh (the `-i` phase).

    tail/head: the workers' int32 [B] rows (padded with n).  Returns (seq,
    pos, m, lo, hi, pst): lo/hi per worker, the rest replicated.  The
    sequence and pst follow parallel.build._sharded_build.
    ``local_pst``: pst per worker, stacked [W, n] (each row counting only
    that shard's edges), for the map-only partials, instead of the sum."""
    tail, head = _i32(tail), _i32(head)
    if with_pos:
        seq, pos_r, m = _given_order(pos, n)
    else:
        seq, pos_r, m = _degree_order_sharded(tail, head, n, mesh)
    pos_ext = torch.cat([pos_r, torch.full((1,), n, dtype=torch.int32,
                                           device=pos_r.device)])
    los, his, psts = [], [], []
    for pos_w, t, h in zip(mesh.scatter(pos_ext), tail, head):
        pt = torch.index_select(pos_w, 0, t.clamp(max=n))
        ph = torch.index_select(pos_w, 0, h.clamp(max=n))
        lo = torch.minimum(pt, ph)
        hi = torch.maximum(pt, ph)
        # pst counts every edge at its present earlier endpoint, edges to
        # absent vids included (jtree.cpp:47-49); self/pad never
        psts.append(pst_weights(torch.where(lo == hi, n, lo), n))
        dead = (lo >= hi) | (hi >= n)
        los.append(torch.where(dead, n, lo))
        his.append(torch.where(dead, n, hi))
    pst = mesh.all_gather(psts) if local_pst else mesh.psum(psts)
    return seq, pos_r, m, los, his, pst


def _pad_pow2_cols(x: int, lo_cap: int = 1 << 10) -> int:
    p = lo_cap
    while p < x:
        p <<= 1
    return p


def gather_links_replicated(lo: list, hi: list, mesh: Mesh):
    """One all-gather of the live link window: the workers' [B] rows ->
    flat [W*B] replicated.  The collective that hands the reduce tail
    off the mesh (see reduce_links_sharded's gather-tail)."""
    return (mesh.all_gather(_i32(lo)).reshape(-1),
            mesh.all_gather(_i32(hi)).reshape(-1))


def _gather_tail_enabled(override: bool | None) -> bool:
    if override is not None:
        return override
    return os.environ.get("SHEEP_MESH_GATHER_TAIL", "1") != "0"


def _tail_shard_enabled(override: bool | None) -> bool:
    """The sharded tail's gate (SHEEP_MESH_TAIL_SHARD, default on): the
    gathered tail is split by vertex window so that per-worker tail work
    falls with W (see reduce_links_sharded)."""
    if override is not None:
        return override
    return os.environ.get("SHEEP_MESH_TAIL_SHARD", "1") != "0"


def hi_window_bounds(sorted_hi: torch.Tensor, cnt, w: int, sent: int):
    """Equal-count hi-quantile window bounds: ``[w + 1]`` values over one
    hi-sorted array (``cnt`` live entries; sentinels ``== sent`` sort
    last), so window k keeps the links whose hi falls in ``[bounds[k],
    bounds[k+1])``.  The windowing rule shared with the hybrid's
    streamed handoff."""
    dt, dev = sorted_hi.dtype, sorted_hi.device
    if w > 1:
        ks = (torch.arange(1, w, dtype=torch.int32, device=dev) * cnt) // w
        mid = torch.index_select(sorted_hi, 0, ks)
    else:
        mid = torch.zeros((0,), dtype=dt, device=dev)
    return torch.cat([torch.zeros((1,), dtype=dt, device=dev), mid,
                      torch.full((1,), sent, dtype=dt, device=dev)])


def shard_links_by_window(lo: torch.Tensor, hi: torch.Tensor, n: int,
                          mesh: Mesh):
    """Replicated flat links -> per-worker rows split by CONTIGUOUS hi
    window: worker i keeps the live links whose hi falls in [q_i,
    q_{i+1}), the live-count quantiles of the hi distribution (one sort,
    once per process; every process derives the same bounds).  Each row
    keeps the flat length, the other links at the sentinel."""
    live = lo < n
    cnt = live.sum(dtype=torch.int32)
    bounds = hi_window_bounds(torch.sort(hi).values, cnt, mesh.size, n)
    b = bounds.tolist()
    rows_lo, rows_hi = [], []
    for i, (lo_w, hi_w) in enumerate(zip(mesh.scatter(lo),
                                         mesh.scatter(hi))):
        g = mesh.offset + i
        mine = (lo_w < n) & (hi_w >= b[g]) & (hi_w < b[g + 1])
        rows_lo.append(torch.where(mine, lo_w, n))
        rows_hi.append(torch.where(mine, hi_w, n))
    return rows_lo, rows_hi


def row_live_counts(lo: list, n: int, mesh: Mesh) -> list:
    """Each mesh row's live-link count (the sharded tail's per-worker
    work, a measurement)."""
    return [int(c) for c in mesh.all_gather(
        [(x != n).sum(dtype=torch.int32) for x in lo]).tolist()]


def _tail_shard_local_rounds() -> int:
    """Round cap of the sharded tail's local pass
    (SHEEP_MESH_TAIL_SHARD_ROUNDS, default 5)."""
    return int(os.environ.get("SHEEP_MESH_TAIL_SHARD_ROUNDS", "5"))


def _gather_tail_factor() -> float:
    """Gather when W * cols <= factor * (n+1) (SHEEP_MESH_GATHER_FACTOR,
    default 2.0)."""
    return float(os.environ.get("SHEEP_MESH_GATHER_FACTOR", "2.0"))


def reduce_links_sharded(lo: list, hi: list, n: int, mesh: Mesh,
                         global_f: bool, levels: int = _LEVELS,
                         jrounds: int = _JROUNDS,
                         first_levels: int = _FIRST_LEVELS,
                         gather_tail: bool | None = None,
                         tail_shard: bool | None = None,
                         comm: dict | None = None, runtime=None,
                         max_rounds: int | None = None):
    """Host-orchestrated chunk loop on the workers' link rows.

    ``global_f`` False is the map phase (each worker on its own), True
    the reduce phase (a ``pmin`` of the jump table each round).  Returns
    (lo, hi, rounds, replicated): replicated False leaves per-worker rows
    with live prefixes; True flat replicated tensors (the gather-tail
    fired).

    Gather-tail: once W * cols <= SHEEP_MESH_GATHER_FACTOR * (n+1) after
    at least one sharded chunk, the links gather once and the tail runs
    through ``ops.forest.reduce_links_hosted``, replicated, with no more
    collectives (SHEEP_MESH_GATHER_TAIL=0 or ``gather_tail=False``
    turns it off).  Sharded tail (SHEEP_MESH_TAIL_SHARD, ``tail_shard``):
    the gathered links are re-split by hi window, collapsed by at most
    SHEEP_MESH_TAIL_SHARD_ROUNDS local rounds on each worker, gathered
    again and finished replicated.

    ``comm`` accumulates the collective-volume model (per-worker payload
    bytes): sharded_global_rounds, pmin_payload_bytes (4(n+1) a global
    round), gather_payload_bytes (8*W*cols a gather), tail_rounds,
    tail_shard_rounds, tail_shard_row_live, tail_gather_live,
    tail_finish_live.

    ``runtime``: an optional runtime.ChunkRuntime.  Each dispatch runs
    under its retry policy (a fault halves jrounds), and in global phases
    each chunk boundary checkpoints the gathered link multiset (the flat
    union of the shards, the rung-portable state).  The gather-tail
    inherits it."""
    cols0 = int(lo[0].shape[0])
    if cols0 == 0:
        return lo, hi, 0, False
    w = mesh.size
    rounds = 0
    chunk_i = 0
    cap = int(np.ceil(np.log2(n + 2)))
    do_gather = global_f and _gather_tail_enabled(gather_tail)
    do_shard = _tail_shard_enabled(tail_shard) and w > 1
    gather_at = _gather_tail_factor() * (n + 1)
    if comm is not None:
        for key in ("sharded_global_rounds", "pmin_payload_bytes",
                    "gather_payload_bytes", "tail_rounds",
                    "tail_shard_rounds"):
            comm.setdefault(key, 0)

    def _finish_hosted(flat_lo, flat_hi, rounds):
        """The replicated single-device finish of the gathered union."""
        from ..ops.forest import reduce_links_hosted
        flat_lo, flat_hi, _, tail_rounds, _ = reduce_links_hosted(
            flat_lo, flat_hi, n, levels=levels, jrounds=jrounds,
            first_levels=first_levels, runtime=runtime)
        if comm is not None:
            comm["tail_rounds"] += tail_rounds
        return flat_lo, flat_hi, rounds + tail_rounds, True

    while True:
        cols = int(lo[0].shape[0])
        # never before the first sharded chunk: the tail's rationale only
        # holds after the mass kill
        if do_gather and chunk_i >= 1 and w * cols <= gather_at:
            flat_lo, flat_hi = gather_links_replicated(lo, hi, mesh)
            if comm is not None:
                comm["gather_payload_bytes"] += 8 * w * cols
                comm["tail_gather_live"] = int(
                    (flat_lo != n).sum(dtype=torch.int32))
            if not do_shard:
                return _finish_hosted(flat_lo, flat_hi, rounds)
            slo, shi = shard_links_by_window(flat_lo, flat_hi, n, mesh)
            if comm is not None:
                comm["tail_shard_row_live"] = row_live_counts(slo, n, mesh)
            slo, shi, local_rounds, _ = reduce_links_sharded(
                slo, shi, n, mesh, global_f=False, levels=levels,
                jrounds=jrounds, first_levels=first_levels,
                runtime=runtime, max_rounds=_tail_shard_local_rounds())
            rounds += local_rounds
            if comm is not None:
                comm["tail_shard_rounds"] += local_rounds
            fcols = int(slo[0].shape[0])
            flat_lo, flat_hi = gather_links_replicated(slo, shi, mesh)
            if comm is not None:
                comm["gather_payload_bytes"] += 8 * w * fcols
                comm["tail_finish_live"] = int(
                    (flat_lo != n).sum(dtype=torch.int32))
            return _finish_hosted(flat_lo, flat_hi, rounds)
        j = _SCHEDULE[chunk_i] if chunk_i < len(_SCHEDULE) else jrounds
        if max_rounds is not None:
            j = max(1, min(j, max_rounds - rounds))
        if global_f:
            # reduce rounds: the flat base depth, as the reference
            lv = min(levels, cap)
        else:
            lv = _depth_tier(cols, cols0, chunk_i < len(_SCHEDULE),
                             levels, first_levels, cap)
        if runtime is not None:
            lv = runtime.cap_levels(lv, n)
        if runtime is None:
            lo, hi, stats = chunk_sharded(lo, hi, n, mesh, lv, j, global_f)
        else:
            (lo, hi, stats), j = runtime.dispatch(
                "mesh_chunk",
                lambda jj: chunk_sharded(lo, hi, n, mesh, lv, jj, global_f),
                j)
        rounds += j
        chunk_i += 1
        if comm is not None and global_f:
            comm["sharded_global_rounds"] += j
            comm["pmin_payload_bytes"] += j * 4 * (n + 1)
        moved_i, live_i = (int(x) for x in stats.tolist())  # one sync
        obs.event("reduce.chunk", live=live_i, moved=moved_i,
                  rounds=rounds, mesh=True)
        if moved_i == 0:
            return lo, hi, rounds, False
        if max_rounds is not None and rounds >= max_rounds:
            # a bounded phase (the sharded tail's local pass): the caller
            # finishes elsewhere, and every chunk keeps the input's
            # threshold connectivity
            return lo, hi, rounds, False
        target = _pad_pow2_cols(live_i)
        if target <= cols // 2:
            lo = [x[:target] for x in lo]
            hi = [x[:target] for x in hi]
        if runtime is not None and global_f:
            def _mesh_links(lo=lo, hi=hi):
                flat_lo, flat_hi = gather_links_replicated(lo, hi, mesh)
                l, h = _fetch(flat_lo), _fetch(flat_hi)
                keep = l < n
                return l[keep], h[keep]
            runtime.boundary(rounds, _mesh_links)


def _extract_parent(lo, hi, n: int, mesh: Mesh, gathered: bool):
    """Parent extraction for either outcome of reduce_links_sharded: the
    gather-tail's replicated links take the single-device scatter-min,
    sharded links the pmin-combined extraction."""
    if gathered:
        return parent_from_links(lo, hi, n)
    return parent_sharded(lo, hi, n, mesh)


def build_links_chunked_sharded(tail_2d: list, head_2d: list, n: int,
                                mesh: Mesh, pos=None, timings=None,
                                unified: bool = True,
                                gather_tail: bool | None = None,
                                tail_shard: bool | None = None,
                                comm: dict | None = None, runtime=None):
    """The chunked mesh build from staged per-worker edge rows.

    Returns (seq, pos, m, parent, pst), replicated; parent int32 [n] with
    n marking roots.  ``timings`` receives the prep/map/reduce seconds
    (host clock, the mesh's devices synchronised), the per-phase rounds,
    ``unified`` and the K1 launches of each local worker's sharded
    rounds (``k1_by_worker``).  ``unified`` (default) runs global rounds
    from the first round; False runs local map rounds to per-worker
    partial forests first, then global rounds (the split form, the
    reference's transportable-partials contract).  ``gather_tail``,
    ``tail_shard``, ``comm``, ``runtime``: see reduce_links_sharded."""
    t0 = time.perf_counter()
    seq, pos_r, m, lo, hi, pst = prep_sharded(
        tail_2d, head_2d, n, mesh, pos=pos, with_pos=pos is not None)
    _sync(mesh)
    t1 = time.perf_counter()
    if unified:
        lo, hi, red_rounds, gathered = reduce_links_sharded(
            lo, hi, n, mesh, global_f=True, gather_tail=gather_tail,
            tail_shard=tail_shard, comm=comm, runtime=runtime)
        map_rounds = 0
        t2 = t1
    else:
        lo, hi, map_rounds, _ = reduce_links_sharded(
            lo, hi, n, mesh, global_f=False, runtime=runtime)
        _sync(mesh)
        t2 = time.perf_counter()
        lo, hi, red_rounds, gathered = reduce_links_sharded(
            lo, hi, n, mesh, global_f=True, gather_tail=gather_tail,
            tail_shard=tail_shard, comm=comm, runtime=runtime)
    parent = _extract_parent(lo, hi, n, mesh, gathered)
    _sync(mesh)
    t3 = time.perf_counter()
    if timings is not None:
        timings.update(prep_s=t1 - t0, map_s=t2 - t1, reduce_s=t3 - t2,
                       map_rounds=map_rounds, reduce_rounds=red_rounds,
                       unified=unified, k1_by_worker=list(mesh.k1_launches))
    return seq, pos_r, m, parent, pst


def stage_edges_2d(tail, head, n: int, mesh: Mesh, block: int | None = None):
    """Host records -> this process's per-worker int32 rows of ``block``
    (default ceil(E/W)) records each, padded with n."""
    w = mesh.size
    e = len(tail)
    b = block if block is not None else (e + w - 1) // w
    b = max(1, b)
    t = np.full((w, b), n, dtype=np.int32)
    h = np.full((w, b), n, dtype=np.int32)
    flat_t = np.asarray(tail)
    flat_h = np.asarray(head)
    for i in range(w):
        sl = slice(i * b, min((i + 1) * b, e))
        k = max(0, sl.stop - sl.start)
        if k:
            t[i, :k] = flat_t[sl]
            h[i, :k] = flat_h[sl]
    return mesh.rows(t), mesh.rows(h)


def prep_stream_sharded(parent: torch.Tensor, tail: list, head: list,
                        pos: torch.Tensor, n: int, cn: int, mesh: Mesh):
    """One streamed block's links and the carry forest's links, sharded.

    parent int32 [n] replicated (n marks roots); tail/head the workers'
    int32 [B] vid rows (padded with values >= len(pos)-1); pos the
    vid -> position table with a sentinel slot last.  Worker i also takes
    carry rows [i*cn, (i+1)*cn) of the forest's (kid -> parent) links.
    Returns (lo, hi per worker [cn + B], pst_delta [n] replicated)."""
    vid_cap = pos.shape[0] - 1
    carry = torch.cat([parent.to(torch.int32),
                       torch.full((mesh.size * cn - n,), n,
                                  dtype=torch.int32, device=parent.device)])
    los, his, psts = [], [], []
    for i, (pos_w, carry_w, t, h) in enumerate(zip(
            mesh.scatter(pos), mesh.scatter(carry), _i32(tail),
            _i32(head))):
        pt = torch.index_select(pos_w, 0, t.clamp(max=vid_cap))
        ph = torch.index_select(pos_w, 0, h.clamp(max=vid_cap))
        lo = torch.minimum(pt, ph)
        hi = torch.maximum(pt, ph)
        psts.append(pst_weights(torch.where(lo == hi, n, lo), n))
        dead = (lo >= hi) | (hi >= n)
        lo = torch.where(dead, n, lo)
        hi = torch.where(dead, n, hi)
        base = (mesh.offset + i) * cn
        kid = base + torch.arange(cn, dtype=torch.int32, device=t.device)
        cpar = carry_w[base:base + cn]
        clive = (kid < n) & (cpar < n)
        los.append(torch.cat([torch.where(clive, kid, n), lo]))
        his.append(torch.cat([torch.where(clive, cpar, n), hi]))
    return los, his, mesh.psum(psts)


def build_graph_streaming_chunked(blocks, n: int, pos: np.ndarray,
                                  block_edges: int,
                                  num_workers: int | None = None,
                                  device=None):
    """Out-of-core streaming over the mesh with bounded dispatches: the
    contract of parallel.stream.build_graph_streaming_sharded, (Forest
    over n positions, total_rounds), each block folding through the
    chunked sharded reduce (unified global rounds).  The carry forest
    re-enters sharded, so per-worker link state stays O(n/W + B/W).
    ``device`` None is CUDA."""
    from ..ops.stream import _full_vid_pos

    mesh = make_mesh(num_workers, resolve_device(device))
    w = mesh.size
    block_pad = max(w, ((block_edges + w - 1) // w) * w)
    b = block_pad // w
    cn = (n + w - 1) // w
    pos_d = mesh.replicate(_full_vid_pos(pos, n).astype(np.int32))
    vid_pad = len(pos)  # pad records map to the table's sentinel slot
    parent = mesh.replicate(np.full(n, n, dtype=np.int32))
    pst = np.zeros(n, dtype=np.int64)
    total_rounds = 0
    for tail, head in blocks:
        k = len(tail)
        if k > w * b:
            raise ValueError(
                f"streamed block of {k} edges exceeds block_edges="
                f"{block_edges} (padded capacity {w * b})")
        t = np.full((w, b), vid_pad, dtype=np.int32)
        h = np.full((w, b), vid_pad, dtype=np.int32)
        for i in range(w):
            sl = slice(i * b, min((i + 1) * b, k))
            cnt = max(0, sl.stop - sl.start)
            if cnt:
                t[i, :cnt] = tail[sl]
                h[i, :cnt] = head[sl]
        lo, hi, pst_delta = prep_stream_sharded(
            parent, mesh.rows(t), mesh.rows(h), pos_d, n, cn, mesh)
        lo, hi, r, gathered = reduce_links_sharded(lo, hi, n, mesh,
                                                   global_f=True)
        parent = _extract_parent(lo, hi, n, mesh, gathered)
        # int64 host accumulation; the uint32 weight contract is the
        # final mask
        pst += _fetch(pst_delta).astype(np.int64)
        total_rounds += r
    parent_np = _fetch(parent).astype(np.int64)
    out = np.full(n, INVALID_JNID, dtype=np.uint32)
    live = parent_np < n
    out[live] = parent_np[live].astype(np.uint32)
    return Forest(out, (pst & 0xFFFFFFFF).astype(np.uint32)), total_rounds


def _stage_inputs(tail, head, num_vertices, num_workers, seq, device):
    """The chunked wrappers' shared prologue: the mesh, the vertex count,
    the staged edges and, with a given sequence, the replicated position
    table.  Returns (mesh, n, t2d, h2d, pos_d); n == 0 is the empty graph
    (arrays None), pos_d None without ``seq``."""
    from .build import _num_vertices

    mesh = make_mesh(num_workers, device)
    n = _num_vertices(tail, head, num_vertices, seq)
    if n == 0:
        return mesh, 0, None, None, None
    t2d, h2d = stage_edges_2d(tail, head, n, mesh)
    pos_d = None
    if seq is not None:
        from ..core.sequence import sequence_positions
        pos_np = sequence_positions(seq, n - 1).astype(np.int64)
        pos_d = mesh.replicate(pos_np.astype(np.int32))
    return mesh, n, t2d, h2d, pos_d


def map_graph_chunked_distributed(tail, head, num_vertices=None,
                                  num_workers=None, seq=None, device=None):
    """Map-only chunked mesh build: (seq uint32 [m], [Forest] * W).

    Each worker's shard reduces with LOCAL rounds only to a partial forest
    over the shared sequence, ready for the file-path merge; each
    partial's pst counts only its shard's edges (graph2tree.cpp:148
    rank-suffixed saves).  ``device`` None is CUDA."""
    mesh, n, t2d, h2d, pos_d = _stage_inputs(
        tail, head, num_vertices, num_workers, seq, resolve_device(device))
    if n == 0:
        return np.empty(0, np.uint32), []
    dseq, _, m, lo, hi, psts = prep_sharded(
        t2d, h2d, n, mesh, pos=pos_d, with_pos=pos_d is not None,
        local_pst=True)
    if pos_d is None:
        m = int(m)
        out_seq = _fetch(dseq)[:m].astype(np.uint32)
    else:
        m = len(seq)
        out_seq = np.asarray(seq, dtype=np.uint32)
    lo, hi, _, _ = reduce_links_sharded(lo, hi, n, mesh, global_f=False)
    parents = _fetch(parent_sharded_local(lo, hi, n, mesh))
    psts_np = _fetch(psts)
    return out_seq, [_to_forest(parents[i], psts_np[i], n, m)
                     for i in range(mesh.size)]


def build_graph_chunked_distributed(tail, head, num_vertices=None,
                                    num_workers=None, seq=None,
                                    timings=None, device=None,
                                    unified: bool = True,
                                    comm: dict | None = None):
    """Host-facing chunked mesh build: (seq uint32 [m], Forest over m),
    the contract of parallel.build.build_graph_distributed.
    ``timings``, ``unified`` and ``comm`` as build_links_chunked_sharded
    takes them.  ``device`` None is CUDA."""
    mesh, n, t2d, h2d, pos_d = _stage_inputs(
        tail, head, num_vertices, num_workers, seq, resolve_device(device))
    if n == 0:
        return (np.empty(0, np.uint32),
                Forest(np.empty(0, np.uint32), np.empty(0, np.uint32)))
    dseq, _, m, parent, pst = build_links_chunked_sharded(
        t2d, h2d, n, mesh, pos=pos_d, timings=timings, unified=unified,
        comm=comm)
    if seq is None:
        m = int(m)
        out_seq = _fetch(dseq)[:m].astype(np.uint32)
    else:
        m = len(seq)
        out_seq = np.asarray(seq, dtype=np.uint32)
    return out_seq, _to_forest(parent, pst, n, m)
