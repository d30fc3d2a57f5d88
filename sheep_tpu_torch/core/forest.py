"""Elimination forest, host oracle (port of sheep_tpu/core/forest.py).

Map each edge {u,v} to sequence positions (lo, hi), lo < hi; each edge
adds 1 to ``pst_weight[lo]``; links processed in ascending-hi order
through a union-find whose representative is the max-position element of
its component give ``parent[find(lo)] = hi``.  The fold itself runs in
the port's own C++ (``native``, csrc/host_fold.cpp); this module maps
records to links around it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import INVALID_JNID
from .sequence import sequence_positions


@dataclass
class Forest:
    """Elimination forest over jnid space (positions in the sequence)."""

    parent: np.ndarray      # uint32 [n], INVALID_JNID for roots
    pst_weight: np.ndarray  # uint32 [n]

    @property
    def n(self) -> int:
        return len(self.parent)

    def copy(self) -> "Forest":
        return Forest(self.parent.copy(), self.pst_weight.copy())


def edges_to_positions(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                       max_vid: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Map edge records to (lo, hi) int64 position pairs, dropping
    self-loops.  An edge with exactly one endpoint in the sequence yields
    (lo = present position, hi = INVALID): pst-only, no tree link.
    Both-absent edges are dropped."""
    pos = sequence_positions(seq, max_vid)
    mx = int(max(tail.max(initial=0), head.max(initial=0))) if len(tail) else 0
    if mx >= len(pos):  # vids beyond the table are absent
        pos = np.concatenate(
            [pos, np.full(mx + 1 - len(pos), INVALID_JNID, np.uint32)])
    pt = pos[tail].astype(np.int64)
    ph = pos[head].astype(np.int64)
    keep = pt != ph  # drops self-loops and both-absent (INVALID == INVALID)
    pt, ph = pt[keep], ph[keep]
    return np.minimum(pt, ph), np.maximum(pt, ph)


def build_forest_links(lo: np.ndarray, hi: np.ndarray, n: int,
                       pst: np.ndarray | None = None) -> Forest:
    """Forest from links (lo -> hi) through the native fold; ``pst``
    None counts one per link at lo (hi >= n links count, never link)."""
    from .. import native
    parent, pst_out = native.build_forest_links(lo, hi, n, pst)
    return Forest(parent, pst_out)


def host_hi_window_bounds(hi: np.ndarray, w: int, n: int) -> list[int]:
    """Equal-count hi-quantile window boundaries over an unsorted host hi
    array (np.partition at the quantile ranks, no full sort).  Window k
    keeps hi in [bounds[k], bounds[k+1])."""
    cnt = len(hi)
    ks = sorted({(k * cnt) // w for k in range(1, w)})
    if not ks or cnt == 0:
        return [0, n]
    mid = np.partition(np.asarray(hi), ks)[ks]
    return [0, *(int(x) for x in mid), n]


def links_fold(n: int, pst: np.ndarray | None = None):
    """The resumable link fold: ``block(lo, hi)`` per ascending-hi window,
    then ``finish() -> (parent, pst)``; always the native
    :class:`~sheep_tpu_torch.native.LinksFold`."""
    from .. import native
    return native.LinksFold(n, pst)


def forest_links(forest: Forest) -> tuple[np.ndarray, np.ndarray]:
    """A tree's (kid, parent) pairs as link arrays."""
    kids = np.nonzero(forest.parent != INVALID_JNID)[0].astype(np.int64)
    return kids, forest.parent[kids].astype(np.int64)


def build_forest(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                 max_vid: int | None = None) -> Forest:
    """Build from raw edge records over a (possibly partial) graph."""
    lo, hi = edges_to_positions(tail, head, seq, max_vid)
    return build_forest_links(lo, hi, len(seq))
