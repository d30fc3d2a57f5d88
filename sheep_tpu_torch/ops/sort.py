"""Degree histogram and (degree, vid) sort on tensors (port of
sheep_tpu/ops/sort.py).

The order is ascending degree with ascending-vid tie-break over the
undirected-doubled degree.  Shapes are static: the sequence runs over all
n vid slots with zero-degree vids pushed to the tail by an INT32_MAX key;
``num_active`` says how many leading entries are real, and positions of
zero-degree vids are n.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import edges_to_device
from ..core.sequence import sequence_positions
from .forest import pst_weights, sort_links

_I32_MAX = int(np.iinfo(np.int32).max)


def degree_histogram(tail: torch.Tensor, head: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Undirected-doubled degrees, int32 [n]."""
    deg = torch.zeros(n, dtype=torch.int32, device=tail.device)
    deg.index_add_(0, tail, torch.ones_like(tail, dtype=torch.int32))
    deg.index_add_(0, head, torch.ones_like(head, dtype=torch.int32))
    return deg


def degree_order(deg: torch.Tensor):
    """(seq, pos, num_active) from a dense degree histogram.

    seq: int32 [n] vids by (degree asc, vid asc), zero-degree last;
    pos: int32 [n] vid -> position, n for zero-degree vids;
    num_active: int32 0-d tensor.
    """
    n = deg.shape[0]
    vid = torch.arange(n, dtype=torch.int32, device=deg.device)
    live = deg > 0
    key = torch.where(live, deg.to(torch.int32), _I32_MAX)
    # one packed (key << 32 | vid) sort; key <= INT32_MAX keeps it positive
    _, seq = sort_links(key, vid)
    pos_all = torch.zeros(n, dtype=torch.int32, device=deg.device)
    pos_all[seq.long()] = vid
    pos = torch.where(live, pos_all, n)
    return seq, pos, live.sum(dtype=torch.int32)


def edge_links(tail: torch.Tensor, head: torch.Tensor, pos: torch.Tensor,
               n: int):
    """Edge records -> sentinel-padded (lo, hi) position links; self-loops
    become sentinels (excluded from the tree)."""
    pt = torch.index_select(pos, 0, tail)
    ph = torch.index_select(pos, 0, head)
    lo = torch.minimum(pt, ph)
    hi = torch.maximum(pt, ph)
    dead = lo == hi
    return torch.where(dead, n, lo), torch.where(dead, n, hi)


def given_seq_links(tail: torch.Tensor, head: torch.Tensor, seq, n: int,
                    with_pst: bool = True):
    """Links + pst for an externally given (possibly subset) sequence: an
    edge whose earlier endpoint is present counts toward pst even when
    the other endpoint is absent; only fully present links enter the
    tree; self-loops never count.  Returns (lo, hi, pst) on tail's
    device, lo/hi sentinel-masked; pst is None when ``with_pst`` is
    False."""
    pos_np = sequence_positions(np.asarray(seq, np.uint32),
                                n - 1).astype(np.int64)
    pos_np = np.where((pos_np < 0) | (pos_np >= n), n, pos_np)
    pos_d = torch.from_numpy(pos_np.astype(np.int32)).to(tail.device)
    lo, hi = edge_links(tail, head, pos_d, n)
    pst = pst_weights(torch.where(lo == hi, n, lo), n) if with_pst else None
    dead = hi >= n
    return torch.where(dead, n, lo), torch.where(dead, n, hi), pst


def degree_sequence_device(tail: np.ndarray, head: np.ndarray,
                           num_vertices: int | None = None,
                           device=None) -> np.ndarray:
    """Host-facing: the degree sequence computed on ``device`` (active
    vids only, uint32)."""
    device = resolve_device(device)
    n = num_vertices
    if n is None:
        n = int(max(tail.max(initial=0), head.max(initial=0))) + 1 \
            if len(tail) else 0
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    t, h = edges_to_device(tail, head, device)
    seq, _, m = degree_order(degree_histogram(t, h, n))
    return seq[:int(m)].cpu().numpy().astype(np.uint32)
