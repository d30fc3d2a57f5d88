"""Elimination-forest reduction on torch tensors (port of
sheep_tpu/ops/forest.py; the algorithm and its soundness argument are in
that module's docstring).

The elimination forest is a function of threshold connectivity of the
position graph under edge weight w({lo, hi}) = hi, so any transform that
preserves it preserves the forest.  Each round sorts the links, rewrites
hub stars into chains (killing duplicates) and advances every lo to its
maximal f-ancestor strictly below hi, where f is the min up-neighbour
table; dead links park at the sentinel n so shapes only shrink when the
host loop compacts.  At the fixpoint the links are the forest.

Port notes, each a place where torch differs from jnp:
- link sorts pack one int64 key, ``(lo << 32) | hi`` (torch has no
  multi-key sort; equal keys are equal values, so stability is moot);
- jnp's ``.at[].min`` is ``scatter_reduce_(..., "amin", include_self=True)``
  into a table whose slot n absorbs the sentinels;
- jnp's ``mode="drop"`` scatters become scatters into one extra trash slot
  that is sliced off (``vremap_compact``, ``_scatter_lo``);
- every gather index is in [0, n] by construction (torch does not clamp);
- counts use ``sum(dtype=torch.int32)`` (torch sums integers into int64).

The reference's ``fori_loop`` chunks are host loops over the same rounds;
each chunk's stats stay one stacked int32 tensor, so a chunk costs one
host sync.  On CUDA the descent runs through kernel K1
(``ops.fused_jump``), in the span ``forest.k1``, and :data:`k1_bytes`
counts its least bytes; on the CPU it runs through its plain version.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import INVALID_JNID
from ..core.forest import Forest
from ..obs import trace as obs
from .fused_jump import fused_descend, fused_descend_plain

_MASK32 = 0xFFFFFFFF

#: the least bytes of every K1 descent on the card since the last reset
#: (set it to 0 to reset): lo and hi read and lo written once, 12 bytes a
#: link, and each of the descent's tables read once, 4 bytes an entry a
#: level, however many launches the descent is split into
k1_bytes = 0


def _i32(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch tensor, got {type(x).__name__}")
    return x.to(torch.int32)


def sort_links(lo: torch.Tensor, hi: torch.Tensor):
    """Lexicographic (lo, hi) sort of int32 link arrays through one packed
    int64 key (exact for the package-wide nonnegative-int32 contract,
    sentinels included)."""
    key = (lo.to(torch.int64) << 32) | hi.to(torch.int64)
    key = torch.sort(key).values
    return (key >> 32).to(torch.int32), (key & _MASK32).to(torch.int32)


def sort_links_by_hi(lo: torch.Tensor, hi: torch.Tensor):
    """Sort the links by ascending hi, lo tie-break (dead sentinel pairs
    last), through the packed key ``(hi << 32) | lo``."""
    key = (hi.to(torch.int64) << 32) | lo.to(torch.int64)
    key = torch.sort(key).values
    return (key & _MASK32).to(torch.int32), (key >> 32).to(torch.int32)


def _rewrite_sorted(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Star -> chain rewrite + dedupe on SORTED (lo, hi): a vertex's
    up-neighbours h1 < h2 < ... < hk become (v,h1), (h1,h2), (h2,h3), ...;
    exact duplicates die.  Returns (lo, hi, applied int32 0-d)."""
    prev_same = torch.zeros_like(lo, dtype=torch.bool)
    prev_same[1:] = lo[1:] == lo[:-1]
    prev_hi = torch.full_like(hi, n)
    prev_hi[1:] = hi[:-1]
    applied = prev_same & (lo != n)
    lo = torch.where(applied, prev_hi, lo)
    # prev_hi <= hi inside a sorted group; equality = duplicate edge, dead
    dead = lo >= hi
    lo = torch.where(dead, n, lo)
    hi = torch.where(dead, n, hi)
    return lo, hi, applied.sum(dtype=torch.int32)


def min_up_table(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """One-step jump table f [n+1]: min up-neighbour per vertex over the
    links (slot n absorbs sentinels)."""
    f = torch.full((n + 1,), n, dtype=torch.int32, device=lo.device)
    return f.scatter_reduce_(0, lo.long(), _i32(hi), "amin",
                             include_self=True)


def _lift_descend(lo: torch.Tensor, hi: torch.Tensor, n: int, levels: int,
                  f: torch.Tensor, sorted_links: bool = False):
    """Binary-lifting descent through a given table f [n+1]: advance each
    lo to its maximal f-ancestor strictly below hi.  Returns (lo, moved).
    The seam of kernel K1: on CUDA the descent always runs through it (in
    one pass when ``sorted_links`` says the links come from sort_links,
    else in L2-sized table groups), on the CPU through its plain
    version.  On the card the descent adds its least bytes to
    :data:`k1_bytes` and runs in the span ``forest.k1``."""
    if lo.device.type == "cuda":
        global k1_bytes
        links, width, depth = int(lo.shape[0]), int(f.shape[0]), \
            max(1, levels)
        nbytes = 12 * links + 4 * depth * width
        k1_bytes += nbytes
        with obs.span("forest.k1", links=links, levels=depth, width=width,
                      bytes=nbytes):
            return fused_descend(lo, hi, n, levels, f, sorted_links)
    return fused_descend_plain(lo, hi, n, levels, f)


def _jump(lo: torch.Tensor, hi: torch.Tensor, n: int, levels: int,
          sorted_links: bool = False):
    """Binary-lifted pointer jump over the live links' own min-up table.
    Returns (lo, moved int32 0-d)."""
    return _lift_descend(lo, hi, n, levels, min_up_table(lo, hi, n),
                         sorted_links)


def _sort_step(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Sort + star->chain rewrite (the fixpoint's accelerator: a pure jump
    round finds a hub's chain one link a round)."""
    lo, hi = sort_links(lo, hi)
    lo, hi, _ = _rewrite_sorted(lo, hi, n)
    return lo, hi


def _round_step(lo: torch.Tensor, hi: torch.Tensor, do_sort: bool, n: int,
                levels: int):
    """One jump round, after a sort rewrite when ``do_sort``.  Returns
    (lo, hi, moved), ``moved`` counting the links whose lo advanced."""
    if do_sort:
        lo, hi = _sort_step(lo, hi, n)
    lo, moved = _jump(lo, hi, n, levels, sorted_links=do_sort)
    return lo, hi, moved


#: the fixpoint's least jump depth (the reference's _JUMP_LEVELS)
_JUMP_LEVELS = 6


def forest_fixpoint(lo: torch.Tensor, hi: torch.Tensor, n: int,
                    jump_levels: int | None = None):
    """Parent array of the elimination forest of links (lo -> hi), lo <
    hi; links with lo == hi == n are ignored (sentinels).  Returns (parent
    int32 [n] on lo's device with n marking roots, rounds).

    The reference runs this as one ``while_loop`` on the device; torch has
    none, so here it is a host loop with one sync a round (on ``moved``).
    Rounds, sort schedule (a sort rewrite at rounds 7, 15, 31, ...) and
    the default depth are the reference's, so the round count is too.  On
    CUDA each round's descent runs through K1 (``_jump``)."""
    if jump_levels is None:
        jump_levels = max(_JUMP_LEVELS, int(np.ceil(np.log2(n + 2))) // 2)
    levels = max(1, min(jump_levels, int(np.ceil(np.log2(n + 2)))))
    lo, hi = _i32(lo), _i32(hi)
    if lo.shape[0] == 0:
        return torch.full((n,), n, dtype=torch.int32, device=lo.device), 0
    rounds = 0
    moved = 1  # a non-empty input always runs its first round
    while moved > 0:
        do_sort = rounds >= 7 and (rounds & (rounds + 1)) == 0
        lo, hi, moved_t = _round_step(lo, hi, do_sort, n, levels)
        rounds += 1
        moved = int(moved_t)  # one sync a round
    return parent_from_links(lo, hi, n), rounds


def _chunk_round(lo, hi, n: int, levels: int):
    """One production round: sort -> chain rewrite -> L-level jump.
    Returns (lo, hi, moved, live), ``live`` counting non-sentinel links
    right after the sort (the tail beyond it stays dead)."""
    lo, hi = sort_links(lo, hi)
    live = (lo != n).sum(dtype=torch.int32)
    lo, hi, rewrites = _rewrite_sorted(lo, hi, n)
    lo, jumped = _jump(lo, hi, n, levels, sorted_links=True)
    return lo, hi, rewrites + jumped, live


def fixpoint_chunk(lo, hi, n: int, levels: int, jrounds: int):
    """``jrounds`` chunk rounds.  Returns (lo, hi, stats) with stats an
    int32 [2] tensor (moved_last_round, live_after_last_sort), stacked so
    the host reads both in one sync."""
    lo, hi = _i32(lo), _i32(hi)
    moved = torch.zeros((), dtype=torch.int32, device=lo.device)
    live = torch.full((), lo.shape[0], dtype=torch.int32, device=lo.device)
    for _ in range(jrounds):
        lo, hi, moved, live = _chunk_round(lo, hi, n, levels)
    return lo, hi, torch.stack([moved, live])


def jump_chunk(lo, hi, n: int, levels: int):
    """One jump-only round (no sort): the opener for full-size arrays.
    Returns (lo, hi, stats) like :func:`fixpoint_chunk`; with no sort,
    ``live`` is only an upper bound with no prefix guarantee."""
    lo, hi = _i32(lo), _i32(hi)
    live = (lo != n).sum(dtype=torch.int32)
    lo, moved = _jump(lo, hi, n, levels)
    return lo, hi, torch.stack([moved, live])


def pack_links_6b(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Pack (lo, hi) int32 pairs with values < 2^24 into uint8 [k, 6]
    (24-bit little-endian halves)."""
    lo, hi = _i32(lo), _i32(hi)
    return torch.stack(
        [lo & 0xFF, (lo >> 8) & 0xFF, (lo >> 16) & 0xFF,
         hi & 0xFF, (hi >> 8) & 0xFF, (hi >> 16) & 0xFF],
        dim=1).to(torch.uint8)


def unpack_links_6b(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`pack_links_6b` (numpy): the plain
    version of ``native.unpack_links_6b``, which the handoff runs."""
    b = buf.astype(np.int32)
    lo = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    hi = b[:, 3] | (b[:, 4] << 8) | (b[:, 5] << 16)
    return lo, hi


def parent_from_links(lo, hi, n: int) -> torch.Tensor:
    """Scatter-min parent extraction (valid once the links form a forest);
    int32 [n] with n marking roots."""
    return min_up_table(_i32(lo), _i32(hi), n)[:n]


def _pad_pow2(x: int, lo_cap: int = 1 << 12) -> int:
    p = lo_cap
    while p < x:
        p <<= 1
    return p


def vremap_compact(lo: torch.Tensor, hi: torch.Tensor, n: int, nc: int):
    """Relabel the vertices of the live links into a dense space [0, nc)
    by ascending rank among the distinct live endpoints (strictly
    monotone, so the forest is unchanged; the reference docstring has the
    argument).  Requires nc >= distinct live endpoints.  Returns
    (lo_c, hi_c, back), back int32 [nc + 1]: compact id -> original
    position, n in back[nc] and unused slots."""
    lo, hi = _i32(lo), _i32(hi)
    dev = lo.device
    verts = torch.sort(torch.cat([lo, hi])).values  # sentinels sort last
    is_live = verts < n
    is_new = is_live.clone()
    is_new[1:] &= verts[1:] != verts[:-1]
    # every occurrence of a vertex gets the same rank, so duplicate
    # scatter writes agree
    rank = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    # jnp's mode="drop": dropped writes land in a trash slot sliced off
    fwd = torch.full((n + 2,), nc, dtype=torch.int32, device=dev)
    fwd.scatter_(0, torch.where(is_live, verts, n + 1).long(), rank)
    back = torch.full((nc + 2,), n, dtype=torch.int32, device=dev)
    keep = is_live & (rank <= nc)
    back.scatter_(0, torch.where(keep, rank, nc + 1).long(), verts)
    fwd = fwd[:n + 1]
    return (torch.index_select(fwd, 0, lo), torch.index_select(fwd, 0, hi),
            back[:nc + 1])


def vremap_back(lo_c: torch.Tensor, hi_c: torch.Tensor, back: torch.Tensor):
    """Inverse of :func:`vremap_compact` on link arrays."""
    return torch.index_select(back, 0, lo_c), torch.index_select(back, 0, hi_c)


def _vremap_enabled() -> bool:
    return os.environ.get("SHEEP_VREMAP", "1") != "0"


# ---------------------------------------------------------------------------
# Plateau-adaptive round scheduling (the reference's round-6 scheduler).
# Once the per-chunk stats show the live count has plateaued, the loop
# escalates to late-tier depth and runs the sequential straggler crawl on
# the host (plateau_assist_walk), scattering the advanced lo values back.
# SHEEP_PLATEAU_ADAPT=0 disables it; SHEEP_PLATEAU_ASSIST_CAP bounds the
# stragglers walked per assist; SHEEP_PLATEAU_FORCE=1 starts in plateau
# mode.
# ---------------------------------------------------------------------------


def _plateau_enabled() -> bool:
    return os.environ.get("SHEEP_PLATEAU_ADAPT", "1") != "0"


def _plateau_assist_cap() -> int:
    return int(os.environ.get("SHEEP_PLATEAU_ASSIST_CAP", str(1 << 17)))


def plateau_assist_walk(l: np.ndarray, h: np.ndarray, f: np.ndarray,
                        n: int, cap: int | None = None,
                        max_passes: int = 4096) -> tuple[int, int, int]:
    """Host straggler walk: advance every live link's lo to its maximal
    f-ancestor strictly below hi, materializing chain steps (f[y] :=
    min(f[y], hi)) as links land, until no straggler remains.

    l, h, f: int64 numpy arrays (l and f are MUTATED); dead slots hold n,
    f[n] == n.  ``cap`` bounds the initial straggler set (past it the
    walk returns untouched).  Passes after the first recheck only the
    tracked links plus the untracked ones whose lo sits at a freshly
    patched vertex.  Returns (walks, passes, stragglers)."""
    sent_safe = np.minimum(l, n)
    cand = np.nonzero((l < n) & (h > f[sent_safe]))[0]
    if cand.size == 0:
        return 0, 0, 0
    if cap is not None and cand.size > cap:
        return 0, 0, int(cand.size)
    n0 = int(cand.size)
    order = np.argsort(l, kind="stable")
    l0_sorted = l[order]  # pre-walk snapshot (exact for untracked links)
    tracked_mask = np.zeros(l.shape[0], np.bool_)
    tracked_mask[cand] = True
    tracked = cand
    walks = 0
    passes = 0
    while passes < max_passes and cand.size:
        passes += 1
        ids = cand[f[l[cand]] < h[cand]]
        if ids.size == 0:
            break
        walks += int(ids.size)
        sl = l[ids]
        sh = h[ids]
        while True:  # vectorized descent; f is strictly increasing
            nx = f[sl]
            adv = nx < sh
            if not adv.any():
                break
            sl = np.where(adv, nx, sl)
        l[ids] = sl
        before = f[sl]
        np.minimum.at(f, sl, sh)
        patched = np.unique(sl[f[sl] < before])
        if patched.size:
            a = np.searchsorted(l0_sorted, patched, side="left")
            b = np.searchsorted(l0_sorted, patched, side="right")
            spans = [order[x:y] for x, y in zip(a, b) if y > x]
            if spans:
                fresh = np.concatenate(spans)
                fresh = fresh[~tracked_mask[fresh]]
                if fresh.size:
                    tracked_mask[fresh] = True
                    tracked = np.concatenate([tracked, fresh])
        cand = tracked
    return walks, passes, n0


def _pad_pow2_min(x: int, floor: int = 16) -> int:
    p = floor
    while p < x:
        p <<= 1
    return p


def _scatter_lo(lo: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                k: int) -> torch.Tensor:
    """Scatter ``k`` advanced lo values into a copy of lo.  idx/vals are
    padded to k with idx == len(lo); those writes (jnp's mode="drop")
    land in a trash slot that is sliced off."""
    e = lo.shape[0]
    out = torch.empty(e + 1, dtype=lo.dtype, device=lo.device)
    out[:e] = lo
    out.index_copy_(0, torch.where(idx < e, idx, e).long(), _i32(vals))
    return out[:e]


class _PlateauSched:
    """Sticky plateau detector + assist scheduler for the hosted chunk loop.

    Consumes the (moved, live) stats the loop already fetches; once the
    plateau is on, the loop escalates lifting depth to the full cap and
    shrinks chunks to one round around host assists."""

    #: live-count drop per chunk under which the loop is plateaued
    RATIO = 0.95
    #: movers at most this fraction of live also signal the plateau
    MOVED_FRAC = 8

    def __init__(self):
        self.enabled = _plateau_enabled()
        self.cap = _plateau_assist_cap()
        self.on = self.enabled and \
            os.environ.get("SHEEP_PLATEAU_FORCE", "") == "1"
        self.prev_live: int | None = None
        self.assists = 0
        self.walks = 0
        self.bail: int | None = None  # stragglers at the last capped bail
        self.assisted = False  # a non-bailed assist attempt has run

    def observe(self, moved: int, live: int) -> None:
        if not self.enabled or self.on:
            self.prev_live = live
            return
        if self.prev_live is not None and live > self.RATIO * self.prev_live:
            self.on = True
        if moved > 0 and moved * self.MOVED_FRAC <= live:
            self.on = True
        self.prev_live = live

    def wants_assist(self, moved: int) -> bool:
        if not (self.enabled and self.on and 0 < moved <= self.cap):
            return False
        # after a capped bail, retry only once movers clearly decayed
        return self.bail is None or moved * 2 <= self.bail

    def assist(self, lo: torch.Tensor, hi: torch.Tensor, n_cur: int):
        """Run one host assist; returns (lo, advanced).  advanced False
        means the walk bailed (capped) or found nothing, and the caller
        must not book a round for it."""
        l = lo.cpu().numpy().astype(np.int64)
        h = hi.cpu().numpy().astype(np.int64)
        f = min_up_table(lo, hi, n_cur).cpu().numpy().astype(np.int64)
        l_orig = l.copy()
        walks, _, stragglers = plateau_assist_walk(l, h, f, n_cur,
                                                   cap=self.cap)
        if walks == 0 and stragglers > self.cap:
            self.bail = stragglers
            return lo, False
        self.bail = None
        self.assisted = True
        if not walks:
            return lo, False
        self.assists += 1
        self.walks += walks
        changed = np.nonzero(l != l_orig)[0]
        k = _pad_pow2_min(changed.size)
        idx = np.full(k, lo.shape[0], np.int32)
        vals = np.zeros(k, np.int32)
        idx[:changed.size] = changed
        vals[:changed.size] = l[changed]
        return _scatter_lo(lo, torch.from_numpy(idx).to(lo.device),
                           torch.from_numpy(vals).to(lo.device), k), True


def _pipe_width_ok(width: int, pad: int) -> bool:
    """The pipelined-dispatch width gate: engage only at 4x-compacted
    AND width <= 2^17."""
    return 4 * width <= pad and width <= (1 << 17)


def _pipeline_chunks(device: torch.device) -> bool:
    """Pipelined chunk dispatch gate (SHEEP_PIPELINE_CHUNKS overrides):
    on by default on CUDA, where the host enqueues the next chunk while
    the previous chunk's stats come back, off on the CPU."""
    v = os.environ.get("SHEEP_PIPELINE_CHUNKS", "")
    if v != "":
        return v == "1"
    return device.type == "cuda"


#: per-chunk round counts: probe every round while live is collapsing,
#: then batch ``jrounds`` rounds per chunk
_CHUNK_SCHEDULE = (1, 1, 1, 2, 4)


def _depth_tier(size: int, pad: int, in_schedule: bool, levels: int,
                first_levels: int, cap: int) -> int:
    """Three-tier lifting depth: ``first_levels`` while the arrays are at
    full size, ``levels+2`` mid-phase, ``levels+6`` once the arrays are
    below an eighth of the padded size; capped at ``cap``."""
    if in_schedule and size >= pad:
        return first_levels
    if size > pad // 8:
        return min(levels + 2, cap)
    return min(levels + 6, cap)


def _live_links_np(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Host copies of the live links (lo < n), in slot order: the
    checkpointable state at a chunk boundary (runtime/snapshot.py's
    soundness argument).  The mask runs on the links' device, so only
    the live links cross to the host."""
    keep = lo < n
    return lo[keep].cpu().numpy(), hi[keep].cpu().numpy()


def reduce_links_hosted(lo: torch.Tensor, hi: torch.Tensor, n: int,
                        stop_live: int = 0, levels: int = 10,
                        jrounds: int = 8, first_levels: int = 4,
                        handoff_input: bool = False,
                        handoff_sort: bool = True, watch=None,
                        runtime=None):
    """Run chunk rounds until convergence (or until live <= stop_live),
    compacting between chunks.

    lo/hi: int32 tensors (the loop runs on their device), sentinel n for
    dead slots.  Returns (lo, hi, live, rounds, converged): lo/hi on the
    device with every remaining live link in the first ``live`` slots
    (plus possibly a few dead ones — callers mask lo < n), always in the
    original vertex space.

    A jump-only opener runs first; chunks then follow ``_CHUNK_SCHEDULE``
    and repeat ``jrounds``; depth follows :func:`_depth_tier`.  Once the
    arrays have compacted far enough the vertex space compacts too
    (:func:`vremap_compact`, SHEEP_VREMAP=0 disables), and once the live
    count plateaus, host assists take over the straggler crawl
    (:class:`_PlateauSched`).  ``handoff_input`` with an input already at
    or under ``stop_live`` skips the rounds (the output goes straight to
    the native fold; one plain sort first at n >= 2^21, which
    ``handoff_sort`` False skips: the streamed tail orders its windows
    by hi itself).

    ``watch``: an optional hook called with the snapshot ``(lo, hi,
    live)`` once a chunk's stats resolve and neither convergence nor the
    stop has ended the loop, only while no vertex remap is active (the
    snapshot is in the original vertex space, with every live link in its
    first ``live`` slots).  Returning True stops the loop there
    (converged=False).  The hybrid's speculative handoff fetches such a
    snapshot while later chunks run (``ops.build._SpecHandoff``).  Nothing
    writes into a tensor once it was handed out: every round, compaction,
    remap, host assist and K1 launch writes only into tensors it
    allocates, so a snapshot stays what it was while a fetch reads it.

    ``runtime``: an optional ``runtime.ChunkRuntime`` (the fault-tolerant
    build's ``single`` rung passes one).  Every dispatch (the opener and
    each chunk) then runs under its retry/backoff/watchdog policy, which
    may halve a chunk's round count after a fault; ``runtime.cap_levels``
    caps each chunk's depth to the memory budget; and each chunk boundary
    hands the live links to ``runtime.boundary`` while the loop is still
    in the original vertex space (after a remap the last such checkpoint
    stands).  Checkpoint boundaries need settled state, so the pipeline
    is off.  Without a runtime the loop is unchanged.
    """
    lo, hi = _i32(lo), _i32(hi)
    e = int(lo.shape[0])
    if e == 0:
        return lo, hi, 0, 0, True
    pad = _pad_pow2(e)
    if pad != e:
        fill = torch.full((pad - e,), n, dtype=torch.int32, device=lo.device)
        lo = torch.cat([lo, fill])
        hi = torch.cat([hi, fill])
    if handoff_input and stop_live and e <= stop_live:
        if n >= (1 << 21) and handoff_sort:
            lo, hi = sort_links(lo, hi)
        return lo, hi, e, 0, False
    rounds = 0
    chunk_i = 0
    n_cur = n  # current vertex-space size (shrinks at each remap)
    back = None  # compact id -> ORIGINAL position, composed across remaps
    remap_on = _vremap_enabled()

    def _restore(lo, hi):
        return (lo, hi) if back is None else vremap_back(lo, hi, back)

    # jump-only opener; its stats are deliberately not read
    if runtime is None:
        lo, hi, _ = jump_chunk(lo, hi, n, first_levels)
    else:
        (lo, hi, _), _ = runtime.dispatch(
            "chunk", lambda _j: jump_chunk(lo, hi, n, first_levels))
    rounds += 1
    # pipelined dispatch: the next chunk is enqueued before the previous
    # chunk's stats are read; compaction is one chunk late, which is sound
    # because live counts only fall and rewrites never resurrect a link
    pipeline = _pipeline_chunks(lo.device) and runtime is None
    prev = None  # (lo, hi, stats) of the chunk whose stats are unread

    def _consume(stats, alo, ahi, rounds_ret):
        """The exit policy once a chunk's stats resolve, shared by the
        sync, pipelined and drain sites: returns (exit_tuple | None,
        live, moved)."""
        moved_i, live_i = (int(x) for x in stats.tolist())  # one sync
        if moved_i == 0:
            rlo, rhi = _restore(alo, ahi)
            return (rlo, rhi, live_i, rounds_ret, True), live_i, moved_i
        if stop_live and live_i <= stop_live:
            rlo, rhi = _restore(alo, ahi)
            return (rlo, rhi, live_i, rounds_ret, False), live_i, moved_i
        if watch is not None and back is None and watch(alo, ahi, live_i):
            return (alo, ahi, live_i, rounds_ret, False), live_i, moved_i
        return None, live_i, moved_i

    def _compact(alo, ahi, live_i):
        target = _pad_pow2(live_i)
        if target <= alo.shape[0] // 2:
            return alo[:target], ahi[:target]
        return alo, ahi

    plate = _PlateauSched()
    while True:
        j = _CHUNK_SCHEDULE[chunk_i] if chunk_i < len(_CHUNK_SCHEDULE) \
            else jrounds
        cap = int(np.ceil(np.log2(n_cur + 2)))
        lv = _depth_tier(int(lo.shape[0]), pad,
                         chunk_i < len(_CHUNK_SCHEDULE),
                         levels, first_levels, cap)
        if plate.on:
            # late-tier depth; j=1 chunks once an assist has run
            lv = min(levels + 6, cap)
            if plate.assisted:
                j = 1
        if runtime is None:
            nlo, nhi, stats = fixpoint_chunk(lo, hi, n_cur, lv, j)
        else:
            # the memory budget caps the depth (the jump tables are the
            # loop's largest allocation); a retry may halve j, and the
            # rounds booked are the ones that ran
            lv = runtime.cap_levels(lv, n_cur)
            (nlo, nhi, stats), j = runtime.dispatch(
                "chunk", lambda jj: fixpoint_chunk(lo, hi, n_cur, lv, jj), j)
        rounds += j
        chunk_i += 1
        use_pipe = pipeline and back is None and not plate.on \
            and _pipe_width_ok(int(lo.shape[0]), pad)
        if not use_pipe:
            if prev is not None:
                # the gate just turned off: drain the predecessor's stats
                _, _, pstats = prev
                prev = None
                exit_t, live_i, _ = _consume(pstats, lo, hi, rounds - j)
                if exit_t is not None:
                    return exit_t
                nlo, nhi = _compact(nlo, nhi, live_i)
            exit_t, live_i, moved_i = _consume(stats, nlo, nhi, rounds)
            if exit_t is not None:
                return exit_t
            lo, hi = _compact(nlo, nhi, live_i)
            plate.observe(moved_i, live_i)
            if plate.wants_assist(moved_i):
                lo, advanced = plate.assist(lo, hi, n_cur)
                if advanced:
                    rounds += 1
            if runtime is not None and back is None:
                # a chunk boundary in the original vertex space: the live
                # multiset is the checkpointable state
                runtime.boundary(rounds, lambda: _live_links_np(lo, hi, n))
        else:
            if prev is not None:
                plo, phi, pstats = prev
                # on an exit the in-flight chunk is discarded, its rounds
                # uncounted (rounds - j)
                exit_t, live_i, moved_i = _consume(pstats, plo, phi,
                                                   rounds - j)
                if exit_t is not None:
                    return exit_t
                nlo, nhi = _compact(nlo, nhi, live_i)
                plate.observe(moved_i, live_i)
            prev = (nlo, nhi, stats)
            lo, hi = nlo, nhi
        cols = int(lo.shape[0])
        # remap trigger: >= 4x table-work shrink; 2x on the plateau
        remap_den = 2 if plate.on else 4
        if remap_on and 2 * cols <= n_cur // remap_den \
                and n_cur > (1 << 16):
            if prev is not None:
                # drain the pipeline: the remap needs settled state
                _, _, pstats = prev
                prev = None
                exit_t, live_i, _ = _consume(pstats, lo, hi, rounds)
                if exit_t is not None:
                    return exit_t
                lo, hi = _compact(lo, hi, live_i)
                cols = int(lo.shape[0])
            lo, hi, back_step = vremap_compact(lo, hi, n_cur, 2 * cols)
            back = back_step if back is None else \
                torch.index_select(back, 0, back_step)
            n_cur = 2 * cols


def forest_fixpoint_hosted(lo: torch.Tensor, hi: torch.Tensor, n: int,
                           levels: int = 10, jrounds: int = 8):
    """Host-orchestrated fixpoint: returns (parent int32 [n] on lo's
    device with n marking roots, rounds)."""
    lo, hi, _, rounds, _ = reduce_links_hosted(
        lo, hi, n, levels=levels, jrounds=jrounds)
    return parent_from_links(lo, hi, n), rounds


def pst_weights(lo: torch.Tensor, n: int) -> torch.Tensor:
    """Per-node postorder edge weight: one count per link at its lo
    (slot n absorbs sentinel links); int32 [n]."""
    lo = _i32(lo)
    out = torch.zeros(n + 1, dtype=torch.int32, device=lo.device)
    out.index_add_(0, lo, torch.ones_like(lo))
    return out[:n]


def links_from_parent(parent: torch.Tensor, n: int):
    """A forest's (kid -> parent) pairs as sentinel-padded link arrays
    (int32 [n] each, roots at the sentinel n)."""
    kid = torch.arange(n, dtype=torch.int32, device=parent.device)
    live = parent < n
    return (torch.where(live, kid, n).to(torch.int32),
            torch.where(live, _i32(parent), n).to(torch.int32))


def merge_parents(parents: torch.Tensor, psts: torch.Tensor, n: int):
    """Merge k same-sequence partial forests (the reference's
    lib/jnode.cpp:174-250 merge): every partial's (kid -> parent) links
    through one fixpoint.  parents int32 [k, n] with n marking roots,
    psts int32 [k, n].  Returns (parent int32 [n], pst int32 [n],
    rounds)."""
    k = parents.shape[0]
    kid = torch.arange(n, dtype=torch.int32,
                       device=parents.device).expand(k, n)
    live = parents < n
    lo = torch.where(live, kid, n).to(torch.int32).reshape(-1)
    hi = torch.where(live, _i32(parents), n).to(torch.int32).reshape(-1)
    parent, rounds = forest_fixpoint(lo, hi, n)
    return parent, psts.sum(dim=0, dtype=torch.int32), rounds


def build_forest_device(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                        max_vid: int | None = None, device=None) -> Forest:
    """Device-built Forest from raw edge records over a given sequence
    (the reference's test and CLI entry point).  ``device`` None is
    CUDA."""
    from .. import resolve_device
    from ..core.forest import edges_to_positions

    device = resolve_device(device)
    lo, hi = edges_to_positions(tail, head, seq, max_vid)
    n = len(seq)
    # pst-only links (hi = INVALID: an edge to a vertex absent from the
    # sequence) count toward pst but are sentineled out of the fixpoint
    pst_only = hi >= n
    lo_d = torch.from_numpy(lo.astype(np.int32)).to(device)
    pst = pst_weights(lo_d, n)
    live_lo = torch.from_numpy(np.where(pst_only, n, lo).astype(np.int32))
    live_hi = torch.from_numpy(np.where(pst_only, n, hi).astype(np.int32))
    parent, _ = forest_fixpoint(live_lo.to(device), live_hi.to(device), n)
    return _to_forest(parent, pst, n)


def merge_forests_device(*forests: Forest, device=None) -> Forest:
    """Device merge of host Forests (equal to core.merge_forests).
    ``device`` None is CUDA."""
    from .. import resolve_device

    device = resolve_device(device)
    n = forests[0].n
    parents = np.stack([
        np.where(f.parent == INVALID_JNID, n, f.parent.astype(np.int64))
        for f in forests]).astype(np.int32)
    psts = np.stack([f.pst_weight.astype(np.int32) for f in forests])
    parent, pst, _ = merge_parents(torch.from_numpy(parents).to(device),
                                   torch.from_numpy(psts).to(device), n)
    return _to_forest(parent, pst, n)


def _to_forest(parent, pst, n: int) -> Forest:
    """Host Forest from device (or numpy) parent/pst over n slots."""
    parent = _np(parent).astype(np.int64)
    pst = _np(pst).astype(np.uint32)
    out = np.full(n, INVALID_JNID, dtype=np.uint32)
    live = parent < n
    out[live] = parent[live].astype(np.uint32)
    return Forest(out, pst)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
