"""Elimination forest, host oracle (port of sheep_tpu/core/forest.py).

Map each edge {u,v} to sequence positions (lo, hi), lo < hi; each edge
adds 1 to ``pst_weight[lo]``; links processed in ascending-hi order
through a union-find whose representative is the max-position element of
its component give ``parent[find(lo)] = hi`` (the reference's streaming
insert, lib/jtree.cpp:34-55).  Within one hi-group the link order does
not change the parent array, and the same routine is the associative
tree merge (lib/jnode.cpp:174-201): a tree's (kid, parent) pairs
re-inserted as links.

The fold runs in the port's native library (``native``,
csrc/sheep_native.cpp).  ``impl="python"`` selects this module's loops,
the oracle the tests hold the library against; ``"auto"`` and
``"native"`` both mean the library, which raises if it cannot build.
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
    pos, pt, ph = _positions_through(pos, tail, head)
    keep = pt != ph  # drops self-loops and both-absent (INVALID == INVALID)
    pt, ph = pt[keep], ph[keep]
    return np.minimum(pt, ph), np.maximum(pt, ph)


def _positions_through(pos: np.ndarray, tail: np.ndarray, head: np.ndarray):
    """Gather endpoint positions, extending the table over any vids beyond
    it (they are absent: INVALID).  Returns (pos, pt, ph); the possibly
    extended table comes back so block-streaming callers keep it."""
    mx = int(max(tail.max(initial=0), head.max(initial=0))) if len(tail) else 0
    if mx >= len(pos):
        pos = np.concatenate(
            [pos, np.full(mx + 1 - len(pos), INVALID_JNID, np.uint32)])
    return pos, pos[tail].astype(np.int64), pos[head].astype(np.int64)


def native_or_none(impl: str):
    """Resolve the ``impl`` dispatch: the native module, or None for the
    python oracle.  "auto" and "native" both mean the native library,
    which raises if it cannot build (the port has no silent fallback)."""
    if impl not in ("auto", "python", "native"):
        raise ValueError(f"impl must be auto|python|native, got {impl!r}")
    if impl == "python":
        return None
    from .. import native
    native.load_library()
    return native


def _find(uf: np.ndarray, x: int) -> int:
    """Find with path compression; representative = max element of
    component."""
    root = x
    while uf[root] != root:
        root = uf[root]
    while uf[x] != root:
        uf[x], x = root, uf[x]
    return root


def build_forest_links(lo: np.ndarray, hi: np.ndarray, n: int,
                       pst: np.ndarray | None = None,
                       impl: str = "auto") -> Forest:
    """Forest from links (lo -> hi), lo < hi elementwise.  ``pst`` None
    counts one per link at lo (hi >= n links count, never link); a given
    ``pst`` (the merge's) is used as is."""
    forest, _ = _build_forest_links_pre(lo, hi, n, pst, False, impl)
    return forest


def _build_forest_links_pre(lo, hi, n, pst, compute_pre: bool, impl: str):
    """Shared worker: returns (Forest, pre | None).

    ``compute_pre`` adds the reference's USE_PRE_WEIGHT accounting
    (lib/jnode.h:174-176 meetKid): each tree link adds 1 to pre[r] where r
    is lo's component root before this hi-group's adoptions; unions are
    deferred to the end of the group (adoptKids, jtree.cpp:102)."""
    native = native_or_none(impl)
    if native is not None:
        out = native.build_forest_links(lo, hi, n, pst,
                                        compute_pre=compute_pre)
        return Forest(out[0], out[1]), (out[2] if compute_pre else None)
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    if pst is None:
        pst = np.bincount(lo, minlength=n)[:n]
    parent = np.full(n, INVALID_JNID, dtype=np.uint32)
    pre = np.zeros(n, dtype=np.uint32) if compute_pre else None
    uf = np.arange(n, dtype=np.int64)
    linked = hi < n  # hi >= n marks pst-only links (absent endpoint)
    lo, hi = lo[linked], hi[linked]
    order = np.argsort(hi, kind="stable")
    lo_s, hi_s = lo[order], hi[order]
    m = len(lo_s)
    i = 0
    while i < m:
        h = int(hi_s[i])
        adopted = []
        while i < m and int(hi_s[i]) == h:
            r = _find(uf, int(lo_s[i]))
            if pre is not None:
                pre[r] += 1
            if r != h and parent[r] == INVALID_JNID:
                parent[r] = h  # r is the max of its component, h > r
                adopted.append(r)
            i += 1
        for r in adopted:  # deferred re-root (adoptKids)
            uf[r] = h
    return Forest(parent, np.asarray(pst).astype(np.uint32)), pre


class PyLinksFold:
    """Python-oracle twin of :class:`~sheep_tpu_torch.native.LinksFold`:
    the exact link build consumed one ascending-hi window at a time
    against shared union-find state.  Same contract: an equal-hi group may
    split across adjacent windows; an out-of-order window raises
    ValueError; ``pst`` None accumulates pst from the streamed records."""

    def __init__(self, n: int, pst: np.ndarray | None = None):
        self.n = n
        self.accumulate_pst = pst is None
        self.parent = np.full(n, INVALID_JNID, dtype=np.uint32)
        self._pst = np.zeros(n, dtype=np.int64) if pst is None \
            else np.asarray(pst, dtype=np.int64).copy()
        self._uf = np.arange(n, dtype=np.int64)
        self._bound = 0

    def block(self, lo: np.ndarray, hi: np.ndarray) -> None:
        n = self.n
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        if len(lo) and int(lo.max()) >= n:
            raise ValueError(f"malformed link: lo >= n ({n})")
        if self.accumulate_pst and len(lo):
            self._pst += np.bincount(lo, minlength=n)[:n]
        linked = hi < n
        lo, hi = lo[linked], hi[linked]
        if len(hi) and int(hi.min()) < self._bound:
            raise ValueError(
                "out-of-order fold window: a linked hi precedes the "
                "previous window's range; windows must ascend by hi")
        order = np.argsort(hi, kind="stable")
        lo_s, hi_s = lo[order], hi[order]
        uf, parent = self._uf, self.parent
        m = len(lo_s)
        i = 0
        while i < m:
            h = int(hi_s[i])
            adopted = []
            while i < m and int(hi_s[i]) == h:
                r = _find(uf, int(lo_s[i]))
                if r != h and parent[r] == INVALID_JNID:
                    parent[r] = h
                    adopted.append(r)
                i += 1
            for r in adopted:  # deferred re-root (adoptKids)
                uf[r] = h
        if m:
            self._bound = max(self._bound, int(hi_s[-1]))

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        return self.parent, self._pst.astype(np.uint32)


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


def links_fold(n: int, pst: np.ndarray | None = None, impl: str = "auto"):
    """The resumable link fold: ``block(lo, hi)`` per ascending-hi window,
    then ``finish() -> (parent, pst)``; the native
    :class:`~sheep_tpu_torch.native.LinksFold`, or :class:`PyLinksFold`
    under ``impl="python"``."""
    native = native_or_none(impl)
    if native is not None:
        return native.LinksFold(n, pst)
    return PyLinksFold(n, pst)


def pre_weights(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                max_vid: int | None = None, impl: str = "auto") -> np.ndarray:
    """The reference's pre_weight array for a graph and sequence: pre[k]
    is the number of graph edges between parent(k) and k's subtree at
    adoption time (lib/jnode.h:174-176), the partitioner's -u weight
    model (lib/partition.cpp:44-46)."""
    lo, hi = edges_to_positions(tail, head, seq, max_vid)
    _, pre = _build_forest_links_pre(lo, hi, len(seq), None, True, impl)
    return pre


def build_forest(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                 max_vid: int | None = None, impl: str = "auto") -> Forest:
    """Build from raw edge records over a (possibly partial) graph."""
    native = native_or_none(impl)
    if native is not None:
        pos = sequence_positions(seq, max_vid)
        if native.blocked_enabled():
            # fused kernel: records group straight into the cache-blocked
            # union-find; the link arrays never materialize
            p, w = native.build_forest_edges(tail, head, pos, len(seq))
            return Forest(p, w)
        lo, hi = native.edges_to_links(tail, head, pos)
        p, w = native.build_forest_links(lo, hi, len(seq))
        return Forest(p, w)
    lo, hi = edges_to_positions(tail, head, seq, max_vid)
    return build_forest_links(lo, hi, len(seq), impl=impl)


def build_forest_streaming(blocks, seq: np.ndarray,
                           max_vid: int | None = None,
                           impl: str = "auto") -> Forest:
    """Bounded-memory forest build from edge blocks: per block, map
    records through the position table, fold (carry links + block links)
    exactly, and keep only the resulting forest's links as the carry.
    O(n + block) resident, bit-identical to the whole-graph build; pst
    accumulates per block (links to absent vids included,
    jtree.cpp:47-49)."""
    n = len(seq)
    pos = sequence_positions(seq, max_vid)
    pst = np.zeros(n, dtype=np.int64)
    zero_pst = np.zeros(n, dtype=np.uint32)  # pst tracked here, not per fold
    carry_lo = np.empty(0, dtype=np.int64)
    carry_hi = np.empty(0, dtype=np.int64)
    forest = Forest(np.full(n, INVALID_JNID, dtype=np.uint32),
                    np.zeros(n, dtype=np.uint32))
    for tail, head in blocks:
        pos, pt, ph = _positions_through(pos, tail, head)
        keep = pt != ph  # drops self-loops and both-absent
        pt, ph = pt[keep], ph[keep]
        lo = np.minimum(pt, ph)
        hi = np.maximum(pt, ph)
        # lo is the present endpoint even for pst-only links (hi INVALID)
        pst += np.bincount(lo, minlength=n)[:n]
        tree = hi < n
        forest = build_forest_links(np.concatenate([carry_lo, lo[tree]]),
                                    np.concatenate([carry_hi, hi[tree]]),
                                    n, pst=zero_pst, impl=impl)
        carry_lo, carry_hi = forest_links(forest)
    return Forest(forest.parent, pst.astype(np.uint32))


def forest_links(forest: Forest) -> tuple[np.ndarray, np.ndarray]:
    """A tree's (kid, parent) pairs as link arrays."""
    kids = np.nonzero(forest.parent != INVALID_JNID)[0].astype(np.int64)
    return kids, forest.parent[kids].astype(np.int64)


def merge_forests(*forests: Forest, impl: str = "auto") -> Forest:
    """Associative merge of same-sequence partial forests (the
    reference's pairwise merge, lib/jnode.cpp:174-201): pst_weights add;
    the parent links of every input replay as links.  Forests of
    differing length cannot share a sequence: a typed IncompatibleMerge,
    not an assert."""
    from ..integrity.errors import IncompatibleMerge
    if len(forests) < 1:
        raise IncompatibleMerge("merge of zero forests")
    n = forests[0].n
    sizes = [f.n for f in forests]
    if any(s != n for s in sizes):
        raise IncompatibleMerge(
            f"cannot merge forests of differing length {sizes}: partial "
            f"trees must come from the same sequence over the same graph")
    pst = np.zeros(n, dtype=np.uint64)
    los, his = [], []
    for f in forests:
        pst += f.pst_weight
        k, p = forest_links(f)
        los.append(k)
        his.append(p)
    return build_forest_links(np.concatenate(los), np.concatenate(his), n,
                              pst=pst.astype(np.uint32), impl=impl)
