"""Fennel streaming partitioners, the reference's competitor baselines
(port of sheep_tpu/partition/fennel.py).

``fennel_vertex`` is the in-memory vertex partitioner
(lib/partition.cpp:282-329 + ctor partition.h:68-77): greedy one-pass
placement maximizing (neighbors already in part) - a*((s+w)^y - (s)^y) with
y = 1.5; ``a`` follows the KDD'14 restreaming formula when edge-balanced
(weights = degree, capacity = 2|E|/k * balance) and the original FENNEL
formula when vertex-balanced.  Vertices stream in ascending-vid order (the
reference iterates the node iterator, not the sequence — the `seq` argument
is dead there too).  Ties choose the lowest part id; the scan stops at the
first empty part (all later parts are empty and identical); when no part
passes the hard capacity check the vertex lands in part 0, replicating the
reference's `max_part = 0` initialization.

``fennel_edges`` is the streaming *edge* partitioner prototype
(lib/partition.cpp:331-407): each edge record greedily joins the part its
endpoints already touch most.  Two evident slips in the prototype are
corrected here (intent per the paper; the reference's loop condition
`k != num_parts` never counted touches, and Y's touch bit was never set —
it wrote X's twice at :404-405); constants are parameters instead of the
hardcoded com-lj values at :336-339.
"""

from __future__ import annotations

import numpy as np

from .. import INVALID_PART


def _csr(tail: np.ndarray, head: np.ndarray, n: int):
    src = np.concatenate([tail, head]).astype(np.int64)
    dst = np.concatenate([head, tail]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    dst = dst[order]
    offs = np.zeros(n + 1, dtype=np.int64)
    np.add.at(offs, src + 1, 1)
    np.cumsum(offs, out=offs)
    return offs, dst


def fennel_vertex(tail: np.ndarray, head: np.ndarray, num_parts: int,
                  balance_factor: float = 1.03,
                  edge_balanced: bool = True,
                  max_vid: int | None = None,
                  impl: str = "auto") -> np.ndarray:
    """vid-indexed parts (INVALID_PART where the vid has no edges).

    The python loop below is the semantics oracle (``impl="python"``);
    ``impl="auto"`` runs the native twin (sheep_native.cpp
    sheep_fennel_vertex): the reference's competitor table runs on
    34M-117M-edge graphs, far beyond an interpreter loop.
    """
    n_vid = int(max_vid) + 1 if max_vid is not None else (
        int(max(tail.max(initial=0), head.max(initial=0))) + 1 if len(tail) else 0)
    from ..core.forest import native_or_none
    native = native_or_none(impl)
    if native is not None and n_vid:
        return native.fennel_vertex(tail, head, n_vid, num_parts,
                                    balance_factor, edge_balanced)
    offs, dst = _csr(tail, head, n_vid)
    deg = np.diff(offs)
    active = deg > 0
    if len(tail) == 0 or not active.any():
        return np.full(n_vid, INVALID_PART, dtype=np.int64)
    n = float(active.sum())
    m = float(2 * len(tail))  # directed edge count
    k = float(num_parts)
    y = 1.5
    a = n * (k / m) ** y if edge_balanced else m * (k ** (y - 1.0) / n ** y)
    total_weight = 2 * len(tail) if edge_balanced else int(n)
    max_component = (total_weight // num_parts) * balance_factor

    parts = np.full(n_vid, INVALID_PART, dtype=np.int64)
    part_size = np.zeros(num_parts, dtype=np.float64)

    for X in np.nonzero(active)[0]:
        w = float(deg[X]) if edge_balanced else 1.0
        nbr_parts = parts[dst[offs[X]:offs[X + 1]]]
        nbr_parts = nbr_parts[nbr_parts != INVALID_PART]
        value = np.zeros(num_parts, dtype=np.float64)
        if len(nbr_parts):
            cnt = np.bincount(nbr_parts, minlength=num_parts)
            value += cnt[:num_parts]
        cost = a * ((part_size + w) ** y - part_size ** y)
        score = value - cost
        # consider parts [0..first_empty]; capacity-violating parts skipped
        empties = np.nonzero(part_size == 0.0)[0]
        last = int(empties[0]) if len(empties) else num_parts - 1
        score = score[: last + 1]
        ok = part_size[: last + 1] + w <= max_component
        if ok.any():
            masked = np.where(ok, score, -np.inf)
            best = int(np.argmax(masked))
        else:
            best = 0  # reference fallback: max_part initialized to 0
        parts[X] = best
        part_size[best] += w
    return parts


def fennel_edges(tail: np.ndarray, head: np.ndarray, num_parts: int,
                 balance_factor: float = 1.03,
                 max_vid: int | None = None,
                 impl: str = "auto") -> np.ndarray:
    """Per-edge-record parts (length == number of records).

    Python loop = oracle (``impl="python"``); ``impl="auto"`` runs the
    native twin (sheep_native.cpp sheep_fennel_edges).
    """
    n_vid = int(max_vid) + 1 if max_vid is not None else (
        int(max(tail.max(initial=0), head.max(initial=0))) + 1 if len(tail) else 0)
    e = len(tail)
    if e == 0:
        return np.empty(0, dtype=np.int64)
    from ..core.forest import native_or_none
    native = native_or_none(impl)
    if native is not None:
        return native.fennel_edges(tail, head, n_vid, num_parts,
                                   balance_factor)
    # active-vertex count, consistent with fennel_vertex (sparse vid spaces
    # would otherwise inflate n and weaken the balance penalty)
    deg = np.bincount(tail, minlength=n_vid) + np.bincount(head, minlength=n_vid)
    n = float(max(int((deg > 0).sum()), 1))
    m = float(2 * e)
    k = float(num_parts)
    y = 1.5
    a = m * (k ** (y - 1.0) / n ** y)
    max_component = (e // num_parts) * balance_factor

    eparts = np.full(e, INVALID_PART, dtype=np.int64)
    part_size = np.zeros(num_parts, dtype=np.float64)
    touches = np.zeros((n_vid, num_parts), dtype=bool)

    t = tail.astype(np.int64)
    h = head.astype(np.int64)
    for i in range(e):
        X, Y = t[i], h[i]
        value = touches[X].astype(np.float64) + touches[Y]
        cost = a * ((part_size + 1.0) ** y - part_size ** y)
        score = value - cost
        empties = np.nonzero(part_size == 0.0)[0]
        last = int(empties[0]) if len(empties) else num_parts - 1
        score = score[: last + 1]
        ok = part_size[: last + 1] + 1.0 <= max_component
        if ok.any():
            best = int(np.argmax(np.where(ok, score, -np.inf)))
        else:
            best = 0
        eparts[i] = best
        part_size[best] += 1.0
        touches[X, best] = True
        touches[Y, best] = True
    return eparts
