"""External-memory build: beyond-RAM graphs as a rung of their own (port
of sheep_tpu/ops/extmem.py).

The paper's core property — elimination trees built on edge-disjoint
partial graphs over ONE sequence merge associatively into the tree of the
union (lib/jnode.cpp:174-201) — is exactly what makes a bounded-memory
disk-streaming build possible: fold the ``.dat`` record stream block by
block, never holding more than O(n + block) beyond the file itself.  The
ladder's spill rung folds through a memmap as a degradation FALLBACK;
this module is the fast path: every stage runs through the native
kernels (csrc/sheep_native.cpp) and no stage — not even degree
sequencing — materializes the edge list.

Pipeline (two streaming passes over the same blocks):

  pass 1  degree sequence, out-of-core: per-block native histogram
          accumulation (sheep_degree_histogram_acc) into one int64
          array, then the host counting sort
          (core.sequence.degree_sequence_from_degrees).  Bit-identical
          to the in-RAM sequence: integer adds commute, so the
          accumulated histogram IS the whole-file histogram.
  pass 2  the carry fold: blocks arrive through the double-buffered
          async :class:`~sheep_tpu_torch.io.prefetch.BlockPrefetcher`
          (disk read of block k+1 overlaps the fold of block k), and
          each block folds into the carry forest by one of two exact
          strategies, picked per block by the governor's priced
          estimates (resources.governor.ext_strategy_costs):

            edges  fused native records->forest (sheep_build_forest_edges
                   — the per-block links never materialize host-side),
                   then the bounded merge: (carry ∪ block-forest links)
                   through one resumable fold.  Wins when block >> n.
            links  host position mapping + ONE resumable fold over
                   (carry ∪ block links)
                   (sheep_build_forest_links_begin/_block/_finish via
                   core.forest.links_fold).  Wins for carry-dominated
                   blocks.

          Both are the associative merge, so ANY interleaving of picks
          converges to the bit-identical forest; pst accumulates per
          block (each record counts at its present earlier endpoint,
          absent-vid records included — jtree.cpp:47-49).

Fault story: every block read is a ``dat``-site I/O fault point
(io/edges.iter_dat_blocks + SHEEP_IO_FAULT_PLAN), and an EIO/ENOSPC
mid-stream retries from the last completed block — the in-memory carry
is still exact, so the re-opened stream (``start_edge``) resumes rather
than restarts.  Block boundaries checkpoint through the runtime's
snapshot machinery (rung "ext", ``rounds`` = blocks folded), so a killed
process resumes bit-identically; the deterministic kill point is
``fault_point("ext-boundary")`` after each boundary, mirroring the chunk
drivers' "died between chunks".

Deliberately torch-free, like the reference's jax-free module: the whole
point is peak RSS inside ``SHEEP_MEM_BUDGET``, and torch's baseline
footprint would be most of a small budget.  ops/__init__ resolves
lazily, so importing this module never drags the device stack in; it
takes no ``device`` argument.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import INVALID_JNID
from ..core.forest import (Forest, build_forest_links, links_fold,
                           native_or_none)
from ..core.sequence import degree_sequence_from_degrees, sequence_positions
from ..integrity.errors import IntegrityError
from ..integrity.sidecar import resolve_policy
from ..io.edges import iter_dat_blocks
from ..io.prefetch import BlockPrefetcher
from ..obs import trace as obs
from ..resources.governor import (EXT_PREFETCH, ResourceGovernor,
                                  ext_block_edges, ext_strategy_costs)
from ..runtime.faults import fault_point
from ..runtime.retry import RetryPolicy
from ..runtime.snapshot import Checkpointer, Snapshot, input_signature

_REC_BYTES = 12  # XS1 record (io/edges._XS1_DTYPE)


def dat_num_records(path: str) -> int:
    return os.path.getsize(path) // _REC_BYTES


def should_use_extmem(path: str, governor: ResourceGovernor | None = None
                      ) -> bool:
    """Should the build CLI route this graph through the external-memory
    rung?  Yes when the operator opted in (``SHEEP_EXT_BLOCK`` — the env
    twin of ``--ext``, reachable from scripts) or when a configured
    memory budget cannot hold the in-RAM load + prep (priced at ~24
    bytes per record: uint32 tail/head arrays plus the mapped int32 link
    pair).  Only ``.dat`` files stream (text parsing is not the
    beyond-RAM format)."""
    if not path.endswith(".dat"):
        return False
    if os.environ.get("SHEEP_EXT_BLOCK", ""):
        return True
    gov = governor if governor is not None else ResourceGovernor.from_env()
    head = gov.mem_headroom()
    if head is None:
        return False
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        return False
    return (nbytes // _REC_BYTES) * 24 > head


def range_degree_histogram(path: str, block_edges: int | None = None,
                           start_edge: int = 0,
                           end_edge: int | None = None,
                           max_retries: int = 3,
                           backoff_base_s: float = 0.05,
                           perf: dict | None = None):
    """Pass 1 over one contiguous record slice ``[start_edge, end_edge)``
    of the ``.dat`` stream: per-block native histogram accumulation
    (``sheep_degree_histogram_acc``) through this
    range's OWN prefetcher.  Returns ``(deg int64, max_vid, records)``.

    Integer adds commute, so summing the per-range histograms of a
    disjoint cover of the file IS the whole-file histogram bit for bit —
    the Allreduce-shaped merge the distributed out-of-core build
    (ops/distext.py) runs between its two passes.

    A typed reader fault (EIO/ENOSPC mid-stream — the ``dat`` I/O fault
    site) retries from the last consumed block: the histogram is exact
    up to there (a block is only consumed after its read completed), so
    the re-opened stream resumes the accumulation rather than restarting
    the pass."""
    block = block_edges or ext_block_edges()
    native = native_or_none("auto")
    deg = np.zeros(1 << 10, dtype=np.int64)
    records = 0
    max_vid = 0
    done = 0
    read_s = 0.0
    policy = RetryPolicy(max_retries=max_retries,
                         backoff_base_s=backoff_base_s)
    attempt = 0
    with obs.span("ext.hist", block_edges=block, start_edge=start_edge,
                  end_edge=end_edge) as sp:
        while True:
            pf = BlockPrefetcher(
                iter_dat_blocks(path, block,
                                start_edge=start_edge + done * block,
                                end_edge=end_edge),
                depth=EXT_PREFETCH, trace_name="ext.seq.read")
            try:
                with pf:
                    for tail, head in pf:
                        records += len(tail)
                        mx = int(max(tail.max(initial=0),
                                     head.max(initial=0)))
                        max_vid = max(max_vid, mx)
                        if mx >= len(deg):
                            deg = np.concatenate(
                                [deg,
                                 np.zeros(mx + 1 - len(deg),
                                          dtype=np.int64)])
                        if native is not None:
                            native.degree_histogram_acc(tail, head, deg)
                        else:
                            deg += np.bincount(tail, minlength=len(deg))
                            deg += np.bincount(head, minlength=len(deg))
                        done += 1
                read_s += pf.busy_s
                break
            except OSError:
                read_s += pf.busy_s
                if attempt >= policy.max_retries:
                    raise
                policy.sleep(policy.backoff(attempt))
                attempt += 1
        sp.annotate(records=records, retries=attempt)
    if perf is not None:
        perf["hist_read_s"] = round(read_s, 4)
        perf["hist_retries"] = attempt
    return deg, max_vid, records


def streaming_degree_sequence(path: str, block_edges: int | None = None,
                              max_retries: int = 3,
                              backoff_base_s: float = 0.05,
                              perf: dict | None = None):
    """Out-of-core degree sequence: one prefetched pass over the ``.dat``
    blocks accumulating the undirected-doubled histogram
    (:func:`range_degree_histogram` over the whole file), then the host
    counting sort.  Returns ``(seq uint32, max_vid, num_records)`` —
    bit-identical to ``degree_sequence`` over the loaded file, at O(V)
    resident."""
    t0 = time.perf_counter()
    hist_perf: dict = {}
    with obs.span("ext.seq"):
        deg, max_vid, records = range_degree_histogram(
            path, block_edges, max_retries=max_retries,
            backoff_base_s=backoff_base_s, perf=hist_perf)
        seq = degree_sequence_from_degrees(deg)
    if perf is not None:
        perf["seq_s"] = round(time.perf_counter() - t0, 4)
        perf["seq_read_s"] = hist_perf["hist_read_s"]
        perf["seq_retries"] = hist_perf["hist_retries"]
    return seq, max_vid, records


def _pick_strategy(n: int, carry_links: int, block_records: int,
                   native_ok: bool) -> str:
    """Per-block strategy pick from the governor's priced estimates
    (``SHEEP_EXT_STRATEGY`` = edges|links pins it for A/B arms).  Both
    strategies are exact; the price is bytes touched, so a stale pick
    costs time, never the tree."""
    forced = os.environ.get("SHEEP_EXT_STRATEGY", "")
    if forced in ("edges", "links"):
        return forced if (forced == "links" or native_ok) else "links"
    if not native_ok:
        return "links"
    costs = ext_strategy_costs(n, carry_links, block_records)
    return "edges" if costs["edges"] <= costs["links"] else "links"


class _ExtFold:
    """The carry-fold state of pass 2: parent-so-far as its <= n
    (kid -> parent) links, the order-free pst accumulator, and the shared
    vid->position table.  O(n) resident; each :meth:`fold_block` adds one
    block and leaves the carry converged.

    Positions are below n < 2^32, so the carry and each block's links
    are held as uint32 where the reference holds int64, and the block's
    temporaries are released as soon as they are consumed: the native
    folds take uint32 as is, so no link array is copied on the way in.
    pst accumulates in uint32, whose wrapping adds give the reference's
    int64 sum cast to uint32, and the folds count their own pst, which is
    dropped, instead of taking an n-long zero array.  This halves the
    fold's resident set, which is what a memory budget prices; the links,
    and so the forest and pst, are the reference's."""

    def __init__(self, n: int, pos: np.ndarray):
        self.n = n
        self.pos = np.asarray(pos, dtype=np.uint32)
        self.pst = np.zeros(n, dtype=np.uint32)
        self.carry_lo = np.empty(0, dtype=np.uint32)
        self.carry_hi = np.empty(0, dtype=np.uint32)
        self.parent = np.full(n, INVALID_JNID, dtype=np.uint32)
        self.strategies: dict[str, int] = {}

    def _absorb(self, parent: np.ndarray) -> None:
        """The carry becomes ``parent``'s (kid, parent) links."""
        self.parent = parent
        kids = np.flatnonzero(parent != INVALID_JNID)
        self.carry_hi = parent[kids]
        self.carry_lo = kids.astype(np.uint32)

    def resume(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Restore a checkpointed carry; the links are the state, the
        parent is derived (the roots of the checkpointed links)."""
        forest = build_forest_links(np.asarray(lo, dtype=np.uint32),
                                    np.asarray(hi, dtype=np.uint32), self.n)
        self._absorb(forest.parent)

    def _carry_plus(self, lo: np.ndarray, hi: np.ndarray):
        return (np.concatenate([self.carry_lo, lo]),
                np.concatenate([self.carry_hi, hi]))

    def fold_block(self, tail: np.ndarray, head: np.ndarray) -> str:
        n = self.n
        native = native_or_none("auto")
        strat = _pick_strategy(n, len(self.carry_lo), len(tail),
                               native is not None)
        self.strategies[strat] = self.strategies.get(strat, 0) + 1
        if strat == "edges":
            # fused records->forest: the block's links never materialize
            # host-side; its pst_out is exactly this block's contribution
            # (absent-vid records counted, self-loops dropped)
            p, w = native.build_forest_edges(tail, head, self.pos, n)
            self.pst += w
            del w
            kids = np.flatnonzero(p != INVALID_JNID)
            fold_lo, fold_hi = self._carry_plus(kids.astype(np.uint32),
                                                p[kids])
            del p, kids
            forest = build_forest_links(fold_lo, fold_hi, n)
            del fold_lo, fold_hi
            self._absorb(forest.parent)
            return strat
        # links: host mapping (the exact oracle semantics of
        # core.forest.build_forest_streaming) + one resumable fold over
        # (carry ∪ block links) — a single window, because an unsorted
        # disk stream cannot promise the cross-window ascending-hi
        # contract; the fold machinery is still the begin/_block/_finish
        # kernel underneath
        mx = int(max(tail.max(initial=0), head.max(initial=0))) \
            if len(tail) else 0
        if mx >= len(self.pos):  # vids beyond the table are absent
            self.pos = np.concatenate(
                [self.pos, np.full(mx + 1 - len(self.pos), INVALID_JNID,
                                   np.uint32)])
        pt = self.pos[tail]
        ph = self.pos[head]
        keep = pt != ph  # drops self-loops and both-absent
        hi = np.maximum(pt, ph)[keep]
        lo = np.minimum(pt, ph, out=pt)[keep]
        del pt, ph, keep
        if len(lo):
            # each record counts at its present earlier endpoint (an
            # absent vid maps to INVALID, the largest value)
            self.pst += np.bincount(lo, minlength=n)[:n].astype(np.uint32)
        tree = hi < n
        fold_lo, fold_hi = self._carry_plus(lo[tree], hi[tree])
        del lo, hi, tree
        fold = links_fold(n)
        fold.block(fold_lo, fold_hi)
        del fold_lo, fold_hi
        parent, _ = fold.finish()
        self._absorb(parent)
        return strat


def build_forest_extmem(path: str, block_edges: int | None = None,
                        seq: np.ndarray | None = None,
                        checkpoint_dir: str | None = None,
                        resume: bool = False, max_retries: int = 3,
                        backoff_base_s: float = 0.05,
                        checkpoint_every: int = 1,
                        governor: ResourceGovernor | None = None,
                        integrity: str | None = None,
                        events: list | None = None,
                        perf: dict | None = None,
                        start_edge: int = 0,
                        end_edge: int | None = None,
                        tail_edges=None):
    """The external-memory build: ``(seq uint32 [m], Forest over m)``,
    bit-identical to ``build_forest`` over the loaded file, with peak
    resident memory O(n + block) beyond the interpreter — the edge list
    itself never loads.

    ``seq`` — an externally given elimination order skips pass 1 (the
    ``-s`` case; the absent-vid pst contract holds: records naming vids
    outside the sequence count toward pst, never the tree).
    ``checkpoint_dir``/``resume`` — the runtime's snapshots at block
    boundaries; ``resume`` restarts the stream at the checkpointed block
    (``iter_dat_blocks(start_edge=...)``), producing the bit-identical
    forest.  ``max_retries`` bounds in-process re-opens of the stream
    after a typed reader fault (EIO/ENOSPC mid-block — the
    ``SHEEP_IO_FAULT_PLAN`` ``dat`` site injects these): each retry
    resumes from the in-memory carry at the last completed block.
    ``perf`` gains blocks/read_s/fold_s/overlap_s/overlap_frac (realized
    read/fold overlap, same accounting as the windowed handoff) and the
    per-strategy pick counts.
    ``start_edge``/``end_edge`` — fold only the contiguous record slice
    ``[start_edge, end_edge)`` of the stream: one leg of the
    distributed out-of-core build.  The partial forests of a disjoint
    cover merge associatively to the whole-file forest (the property the
    tournament already carries); the slice is folded into the checkpoint
    identity so a leg's checkpoint can never resume under a different
    shard map.
    ``tail_edges`` — an optional ``(tail, head)`` uint32 pair folded as
    one final in-memory block AFTER the stream (the serving tier's
    logged inserts riding the same fold as the ``.dat`` records — its
    re-sequence rebuild is "the offline build over .dat + log").
    The tail is folded into the checkpoint identity (count + crc), so a
    checkpoint can never resume under a different insert cut; the tail
    block itself is never checkpointed — a crash inside it resumes from
    the last STREAM boundary and refolds it, bit-identically by the
    associative-merge property.
    """
    t_start = time.perf_counter()
    events = events if events is not None else []
    gov = governor if governor is not None else ResourceGovernor.from_env()
    # under a budget the block auto-shrinks to the headroom (an explicit
    # arg or SHEEP_EXT_BLOCK pins it — it is part of the resume identity)
    block = block_edges or gov.ext_fitted_block()
    if seq is None:
        if (start_edge, end_edge) != (0, None):
            # a RANGE build always takes the shared whole-input sequence
            # (the distributed build's histogram merge): a sequence derived
            # from
            # one shard's records would make the partial forests
            # unmergeable (different position spaces)
            raise ValueError(
                "a range build (start_edge/end_edge) needs an explicit "
                "seq — pass the shared whole-input sequence")
        seq, _, _ = streaming_degree_sequence(
            path, block, max_retries=max_retries,
            backoff_base_s=backoff_base_s, perf=perf)
    seq = np.asarray(seq, dtype=np.uint32)
    n = len(seq)
    if n == 0:
        return seq, Forest(np.empty(0, np.uint32), np.empty(0, np.uint32))
    # block size is part of the resume identity: boundary k means
    # "k * block_edges records folded", which only holds at this block.
    # A record slice is too: the same boundary in a different shard map
    # names different records, so the range folds into the signature.
    sig = input_signature(n, seq) + f"|ext:b{block}"
    if (start_edge, end_edge) != (0, None):
        sig += f"|range:{start_edge}:{end_edge}"
    if tail_edges is not None:
        import zlib
        t_t = np.ascontiguousarray(tail_edges[0], dtype=np.uint32)
        t_h = np.ascontiguousarray(tail_edges[1], dtype=np.uint32)
        tcrc = zlib.crc32(t_h.tobytes(), zlib.crc32(t_t.tobytes()))
        sig += f"|tail:{len(t_t)}:{tcrc:08x}"
    ckpt = Checkpointer(checkpoint_dir, checkpoint_every, governor=gov) \
        if checkpoint_dir else None
    fold = _ExtFold(n, sequence_positions(seq))
    done = 0
    if ckpt is not None and resume:
        try:
            snap = ckpt.load(integrity=integrity)
            if snap is not None:
                snap.verify(sig)
        except IntegrityError as exc:
            if resolve_policy(integrity) != "repair":
                raise
            events.append(("corrupt-checkpoint", "ext", str(exc)))
            snap = None
            ckpt.boundary = 0
        if snap is not None:
            fold.pst = snap.pst.astype(np.uint32)
            fold.resume(snap.lo, snap.hi)
            done = snap.rounds
            events.append(("ext-resume", done))
    policy = RetryPolicy(max_retries=max_retries,
                         backoff_base_s=backoff_base_s)
    # fold_series accumulates through obs.trace.timed (one code path
    # with the windowed handoff); read_s is the prefetcher's producer
    # busy time, itself accumulated through the same helper
    stats = {"read_s": 0.0, "fold_series": [], "stream_s": 0.0}
    # progress is shared mutably with the attempt: on a mid-stream fault
    # the blocks folded BEFORE it must survive into the retry, or the
    # re-opened stream would refold them (parent is idempotent under a
    # replay, pst is not — it would double-count)
    progress = {"done": done}
    attempt = 0
    while True:
        try:
            _stream_fold(path, block, seq, sig, fold, progress, ckpt,
                         events, stats, start_edge, end_edge)
            break
        except OSError as exc:
            # a typed environmental reader fault (EIO/ENOSPC mid-stream):
            # the fold state at progress["done"] blocks is exact —
            # re-open the stream there instead of dying or restarting
            if attempt >= policy.max_retries:
                raise
            events.append(("ext-retry", attempt + 1, progress["done"],
                           f"{type(exc).__name__}: {exc}"))
            policy.sleep(policy.backoff(attempt))
            attempt += 1
    done = progress["done"]
    if tail_edges is not None and len(t_t):
        # the WAL'd tail, folded through the SAME carry-fold machinery
        # as the stream blocks (one more partial graph in the
        # associative merge); runs after every stream block so a resume
        # never double-folds it
        with obs.timed("ext.fold", out=stats["fold_series"],
                       block="tail", records=len(t_t)):
            strat = fold.fold_block(t_t, t_h)
        events.append(("ext-tail", len(t_t), strat))
    pst32 = fold.pst.astype(np.uint32)
    forest = Forest(fold.parent.copy(), pst32)
    if ckpt is not None:
        ckpt.clear()
    if perf is not None:
        wall = time.perf_counter() - t_start
        fold_s = sum(stats["fold_series"])
        native = native_or_none("auto")
        perf.update({
            "ext_blocks": done,
            "block_edges": block,
            "read_s": round(stats["read_s"], 4),
            "fold_s": round(fold_s, 4),
            # THE shared overlap accounting (obs.trace.overlap_stats):
            # read+fold serialized vs the stream's realized wall
            **obs.overlap_stats(stats["read_s"] + fold_s,
                                stats["stream_s"]),
            "wall_s": round(wall, 4),
            "strategies": dict(fold.strategies),
            "retries": attempt,
            # fold worker threads: >1 means each block folded
            # on parallel cores WHILE the prefetcher read ahead — the
            # fetch/fold overlap the 1-core records could only cap
            "threads": native.resolve_threads() if native is not None
            else 1,
        })
    return seq, forest


def _stream_fold(path: str, block: int, seq: np.ndarray, sig: str,
                 fold: _ExtFold, progress: dict,
                 ckpt: Checkpointer | None,
                 events: list, stats: dict,
                 start_edge: int = 0, end_edge: int | None = None) -> None:
    """One streaming attempt from block ``progress["done"]`` on, bumping
    it per folded block (in place, so a mid-stream fault keeps the
    completed prefix).  Reader faults (OSError) propagate to the
    caller's retry loop with the fold state intact — the prefetcher's
    producer thread re-raises them typed at the consumption point."""
    t0 = time.perf_counter()
    it = iter_dat_blocks(path, block,
                         start_edge=start_edge + progress["done"] * block,
                         end_edge=end_edge)
    with obs.span("ext.stream", start_block=progress["done"]), \
            BlockPrefetcher(it, depth=EXT_PREFETCH,
                            trace_name="ext.read") as pf:
        try:
            for tail, head in pf:
                with obs.timed("ext.fold", out=stats["fold_series"],
                               block=progress["done"], records=len(tail)):
                    strat = fold.fold_block(tail, head)
                done = progress["done"] = progress["done"] + 1
                events.append(("ext-block", done - 1,
                               len(fold.carry_lo), strat))
                if ckpt is not None:
                    if ckpt.want():
                        ckpt.save(Snapshot(
                            n=fold.n, seq=seq,
                            pst=fold.pst.astype(np.uint32),
                            lo=fold.carry_lo.astype(np.int32),
                            hi=fold.carry_hi.astype(np.int32),
                            rounds=done, boundary=0, rung="ext",
                            input_sig=sig))
                        events.append(("checkpoint", "ext",
                                       ckpt.boundary - 1))
                    else:
                        ckpt.skip()
                # the deterministic kill point: "died between blocks"
                fault_point("ext-boundary")
        finally:
            stats["read_s"] += pf.busy_s
            stats["stream_s"] += time.perf_counter() - t0
