"""Mesh-sharded out-of-core streaming (port of
sheep_tpu/parallel/stream.py).

Each host edge block is sharded over the mesh's workers; every worker
maps its shard over the shared sequence, the carry forest re-enters as
links on every worker, each worker's fixpoint gives a partial forest,
and the partials all-gather and rebuild associatively (the per-block
equivalent of the reference's mpi_merge, lib/jnode.cpp:203-250); pst
accumulates by a sum across the mesh.  Per-worker device state stays
O(n + block/W) for any edge count.

This is the fixpoint twin; the production mesh streaming build is
parallel.chunked.build_graph_streaming_chunked.  The merge fixpoint runs
once per process on the mesh's ``home`` device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import INVALID_JNID, resolve_device
from ..core.forest import Forest
from ..ops import fused_jump
from ..ops.forest import forest_fixpoint, links_from_parent
from ..ops.stream import _full_vid_pos
from .build import _fetch, _gather_merge, _links_from_positions
from .mesh import Mesh, make_mesh


def stream_block_step_sharded(parent: torch.Tensor, pst: torch.Tensor,
                              tail: list, head: list, pos: torch.Tensor,
                              n: int, mesh: Mesh):
    """Fold one mesh-sharded edge block into the replicated carry forest.

    parent int32 [n], pst int64 [n] replicated (int64, so the running sum
    keeps the uint32 weight contract after the final mask instead of
    wrapping at 2^31); tail/head the workers' int32 [B] rows (padded with
    values >= len(pos)-1); pos the _full_vid_pos table.  Returns (parent,
    pst, rounds), replicated."""
    vid_cap = pos.shape[0] - 1
    clo, chi = links_from_parent(parent, n)
    partials, psts = [], []
    for i, (pos_w, clo_w, chi_w, t, h) in enumerate(zip(
            mesh.scatter(pos), mesh.scatter(clo), mesh.scatter(chi), tail,
            head)):
        t = t.to(torch.int32).clamp(max=vid_cap)
        h = h.to(torch.int32).clamp(max=vid_cap)
        blo, bhi, pst_local = _links_from_positions(
            torch.index_select(pos_w, 0, t), torch.index_select(pos_w, 0, h),
            n)
        before = fused_jump.launches
        # the carry forest re-enters as its own links on every worker
        p_local, _ = forest_fixpoint(torch.cat([clo_w, blo]),
                                     torch.cat([chi_w, bhi]), n)
        mesh.k1_launches[i] += fused_jump.launches - before
        partials.append(p_local)
        psts.append(pst_local)
    new_parent, rounds = _gather_merge(partials, n, mesh)
    return new_parent, pst + mesh.psum(psts).to(torch.int64), rounds


def build_graph_streaming_sharded(blocks, n: int, pos: np.ndarray,
                                  block_edges: int,
                                  num_workers: int | None = None,
                                  device=None):
    """Out-of-core streaming over the mesh: the contract of
    ops.stream.build_graph_streaming, every block sharded over the mesh's
    workers.  Returns (Forest over n positions, total_rounds).
    ``device`` None is CUDA."""
    mesh = make_mesh(num_workers, resolve_device(device))
    w = mesh.size
    block_pad = max(w, ((block_edges + w - 1) // w) * w)
    pos_d = mesh.replicate(_full_vid_pos(pos, n))
    vid_pad = len(pos)  # pad records map to the table's sentinel slot
    parent = mesh.replicate(np.full(n, n, dtype=np.int32))
    pst = mesh.replicate(np.zeros(n, dtype=np.int64))
    total_rounds = 0
    for tail, head in blocks:
        b = len(tail)
        t = np.full(block_pad, vid_pad, dtype=np.int32)
        h = np.full(block_pad, vid_pad, dtype=np.int32)
        t[:b] = tail
        h[:b] = head
        parent, pst, rounds = stream_block_step_sharded(
            parent, pst, mesh.rows(t.reshape(w, -1)),
            mesh.rows(h.reshape(w, -1)), pos_d, n, mesh)
        total_rounds += rounds
    parent_np = _fetch(parent).astype(np.int64)
    out = np.full(n, INVALID_JNID, dtype=np.uint32)
    live = parent_np < n
    out[live] = parent_np[live].astype(np.uint32)
    pst_np = (_fetch(pst) & 0xFFFFFFFF).astype(np.uint32)
    return Forest(out, pst_np), total_rounds
