"""Out-of-core streaming build: edge blocks from host memory into the
device (port of sheep_tpu/ops/stream.py).

Users stream a graph whose records do not fit the card in one piece
(``io.edges.iter_dat_blocks`` reads a ``.dat`` file block by block).  The
device keeps only O(n + B) state: a carry (a forest, or the live link
set) plus one B-record block.  Each block step folds the block's links
into the carry; this is exact because a forest re-enters as its own link
set and the merge is associative.  pst accumulates as a per-block
segment-sum.

Two builds: :func:`build_graph_streaming` rebuilds the carry forest per
block with :func:`ops.forest.forest_fixpoint`; the production
:func:`build_graph_streaming_hosted` reduces the carry links per block with
the hosted loop and ends like the hybrid, in ``reduce_and_finish_native``
(every tail arm the hybrid has).  On CUDA every descent runs through
kernel K1.  Each entry point takes ``device=None``, meaning CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import INVALID_JNID, resolve_device
from ..convert import edges_to_device
from ..core.forest import Forest
from ..obs import trace as obs
from . import forest as _forest
from .forest import (_np, _pad_pow2, _to_forest, forest_fixpoint,
                     parent_from_links, pst_weights, reduce_links_hosted)
from .sort import degree_histogram


def _block_links(tail, head, pos, n: int):
    """Map one padded edge block through ``pos`` (the :func:`_full_vid_pos`
    table, [V+1], sentinel slot last) to (lo, hi, pst of the block), dead
    links (loops, padding, absent endpoints) at n."""
    vid_cap = pos.shape[0] - 1
    pt = torch.index_select(pos, 0, tail.clamp(max=vid_cap))
    ph = torch.index_select(pos, 0, head.clamp(max=vid_cap))
    lo = torch.minimum(pt, ph)
    hi = torch.maximum(pt, ph)
    # pst: every record with a present earlier endpoint, absent-endpoint
    # records included (the pst-only contract); loops and padding excluded
    pst = pst_weights(torch.where(lo == hi, n, lo), n)
    dead = (lo >= hi) | (hi >= n)
    return torch.where(dead, n, lo), torch.where(dead, n, hi), pst


def stream_block_step(parent: torch.Tensor, pst: torch.Tensor,
                      tail: torch.Tensor, head: torch.Tensor,
                      pos: torch.Tensor, n: int):
    """Fold one edge block into the carry forest.

    parent int32 [n] (n = root sentinel), pst int32 [n], tail/head int32
    [B] (padded with values >= V), pos int32 [V+1] over the FULL vid
    space (V = max vid + 1, which can far exceed the n active positions),
    absent vids and the pad slot mapped to n.  Returns (parent, pst,
    rounds)."""
    blo, bhi, pst_b = _block_links(tail, head, pos, n)
    pst = pst + pst_b
    # the carry forest re-enters as its own links
    kid = torch.arange(n, dtype=torch.int32, device=parent.device)
    clive = parent < n
    clo = torch.where(clive, kid, n).to(torch.int32)
    chi = torch.where(clive, parent, n).to(torch.int32)
    new_parent, rounds = forest_fixpoint(torch.cat([clo, blo]),
                                         torch.cat([chi, bhi]), n)
    return new_parent, pst, rounds


def _full_vid_pos(pos: np.ndarray, n: int) -> np.ndarray:
    """A vid -> position table for the device: the full vid space plus one
    trailing sentinel slot; absent or invalid entries map to n."""
    posx = np.full(len(pos) + 1, n, dtype=np.int32)
    p = pos.astype(np.int64)
    posx[:-1] = np.where((p < 0) | (p >= n), n, p).astype(np.int32)
    return posx


def _padded_block(tail, head, block_edges: int, vid_pad: int, device,
                  pad_s: list | None = None, upload_s: list | None = None):
    """One block as int32 tensors of ``block_edges`` records, padded with
    ``vid_pad`` (which maps to the table's sentinel slot).  The host
    padding runs in the span ``stream.pad``, the copies to ``device`` in
    ``stream.upload``; ``pad_s`` and ``upload_s`` gain their seconds."""
    b = len(tail)
    with obs.timed("stream.pad", pad_s, records=b):
        t = np.full(block_edges, vid_pad, dtype=np.int64)
        h = np.full(block_edges, vid_pad, dtype=np.int64)
        t[:b] = tail
        h[:b] = head
        t32, h32 = t.astype(np.int32), h.astype(np.int32)
    with obs.timed("stream.upload", upload_s, records=b):
        return (torch.from_numpy(t32).to(device),
                torch.from_numpy(h32).to(device))


def build_graph_streaming(blocks, n: int, pos: np.ndarray, block_edges: int,
                          device=None):
    """Fold an iterator of (tail, head) uint32 blocks into a Forest.

    ``pos``: vid -> position table over the FULL vid space (length >= max
    vid + 1; INVALID for absent vids).  Returns (Forest over n positions,
    total_rounds).  Device memory: O(n + V + block_edges)."""
    device = resolve_device(device)
    pos_d = torch.from_numpy(_full_vid_pos(pos, n)).to(device)
    vid_pad = len(pos)  # pad records map to the table's sentinel slot
    parent = torch.full((n,), n, dtype=torch.int32, device=device)
    pst = torch.zeros(n, dtype=torch.int32, device=device)
    total_rounds = 0
    for tail, head in blocks:
        t, h = _padded_block(tail, head, block_edges, vid_pad, device)
        parent, pst, rounds = stream_block_step(parent, pst, t, h, pos_d, n)
        total_rounds += rounds
    return _to_forest(parent, pst, n), total_rounds


def build_graph_streaming_hosted(blocks, n: int, pos: np.ndarray,
                                 block_edges: int, device=None,
                                 perf: dict | None = None):
    """The production out-of-core build: the hosted reduce loop per block.

    Same contract as :func:`build_graph_streaming`, but each block's fold
    runs ``reduce_links_hosted`` on the carry (the live link set, at most
    about 2n links once reduced) joined with the block's links, and stops
    once live <= 2n: mid-stream the carry only has to stay bounded.  After
    the last block the carry ends like the hybrid: reduced to the handoff
    threshold and finished by the exact union-find
    (``ops.build.reduce_and_finish_native``, whose tail arms follow the
    same knobs).  Returns (Forest over n positions, total_rounds).
    ``perf``: a dict that receives blocks, the blocks' seconds in their
    spans (block_pad_s, ``stream.pad``; block_upload_s, ``stream.upload``;
    block_loop_s, ``stream.loop``; the span ``stream.links`` holds the
    link extraction), the final fold's keys (loop_s, rounds, live,
    fetch_tail_s, ...) and k1_bytes, K1's least bytes in the blocks'
    loops and the final one."""
    from .build import (default_handoff_factor, handoff_input_ok,
                        reduce_and_finish_native)

    device = resolve_device(device)
    pos_d = torch.from_numpy(_full_vid_pos(pos, n)).to(device)
    vid_pad = len(pos)
    carry_lo = carry_hi = None
    pst = torch.zeros(n, dtype=torch.int32, device=device)
    total_rounds = 0
    blocks_seen = 0
    pad_s, upload_s, loop_s = [], [], []
    k1_before = _forest.k1_bytes
    for tail, head in blocks:
        t, h = _padded_block(tail, head, block_edges, vid_pad, device,
                             pad_s, upload_s)
        with obs.span("stream.links"):
            lo, hi, pst_b = _block_links(t, h, pos_d, n)
            pst = pst + pst_b
            if carry_lo is not None:
                lo = torch.cat([carry_lo, lo])
                hi = torch.cat([carry_hi, hi])
        with obs.timed("stream.loop", loop_s, links=int(lo.shape[0])) as sp:
            lo, hi, live, rounds, _ = reduce_links_hosted(lo, hi, n,
                                                          stop_live=2 * n)
            sp.annotate(live=int(live))
        blocks_seen += 1
        total_rounds += rounds
        target = _pad_pow2(live)
        carry_lo, carry_hi = lo[:target], hi[:target]
    if perf is not None:
        perf["blocks"] = blocks_seen
        perf["block_pad_s"] = round(sum(pad_s), 4)
        perf["block_upload_s"] = round(sum(upload_s), 4)
        perf["block_loop_s"] = round(sum(loop_s), 4)
    if carry_lo is None:
        return Forest(np.full(n, INVALID_JNID, np.uint32),
                      np.zeros(n, np.uint32)), 0
    # pst is the per-block count, not recoverable from the carry links
    # (the mid-stream folds rewrote them), so the fold always receives it
    pst_np = _np(pst).astype(np.uint32)
    res = reduce_and_finish_native(
        carry_lo, carry_hi, n, stop_live=default_handoff_factor(device) * n,
        handoff_input=handoff_input_ok(device), pst_h=pst_np, perf=perf)
    if perf is not None:
        perf["k1_bytes"] = _forest.k1_bytes - k1_before
    total_rounds += res[4]
    if res[0] == "device":  # converged before the handoff threshold
        parent = parent_from_links(res[1], res[2], n)
        return _to_forest(parent, pst_np, n), total_rounds
    _, parent_h, pst_out, _, _ = res
    return Forest(parent_h.copy(), pst_out.copy()), total_rounds


def streaming_degree_histogram(blocks, n: int, device=None) -> np.ndarray:
    """Degree histogram from an edge-block iterator (int64 [n])."""
    device = resolve_device(device)
    deg = torch.zeros(n, dtype=torch.int32, device=device)
    for tail, head in blocks:
        t, h = edges_to_device(np.asarray(tail), np.asarray(head), device)
        deg = deg + degree_histogram(t, h, n)
    return _np(deg).astype(np.int64)
