"""Tiered self-validation oracles — analog of ``graph2tree -c``
(lib/jtree.cpp:238-301).

Two tiers:

  FAST  :func:`check_forest_fast` — vectorized O(n + E) invariants usable
         at every chunk / merge / partition boundary: parent pointers in
         range and strictly monotone (parent > kid, so no cycles), pst
         conservation (total == kept edge records), and the per-node pst
         histogram.  Returns a list of human-readable problems; the
         runtime raises IntegrityError when it is non-empty.

  EXACT :func:`is_valid_forest` — the defining elimination-tree invariant
         per edge: for an edge whose endpoints sit at positions lo < hi,
         hi must lie on lo's root path.  The default implementation is a
         chunked binary-lifting (pointer-doubling) walk — O(E log n)
         vectorized, seconds on HepTh-scale graphs where the per-edge
         python loop took minutes.  The loop walker survives as the
         reference implementation (``exact="loop"``, or env
         SHEEP_VALIDATE_LOOP=1 — a test-only flag).

Why binary lifting is exact here: a valid forest's root path from lo is a
strictly increasing position sequence, so "ascend by the largest power-of-
two step that does not overshoot hi" lands exactly on the maximal path
node <= hi; hi is on the path iff that node IS hi.  Monotonicity is
checked first, so the lifted walk never runs on a cyclic parent array.
"""

from __future__ import annotations

import os

import numpy as np

from .. import INVALID_JNID
from .forest import Forest, edges_to_positions


def check_forest_fast(forest: Forest, lo: np.ndarray | None = None,
                      hi: np.ndarray | None = None) -> list[str]:
    """The fast tier: vectorized structural + conservation invariants.

    ``lo``/``hi``: the link multiset in position space (as produced by
    forest.edges_to_positions — pst-only links included, hi >= n).  When
    given, pst conservation and the per-node histogram are checked too;
    without links only the structural invariants run (still enough to
    catch OOB / cyclic parents from a corrupt artifact or a sick rung).
    """
    problems: list[str] = []
    n = forest.n
    parent = forest.parent.astype(np.int64)
    parent[forest.parent == INVALID_JNID] = -1
    linked = parent >= 0
    if len(forest.pst_weight) != n:
        problems.append(
            f"pst_weight length {len(forest.pst_weight)} != n {n}")
    oob = linked & (parent >= n)
    if oob.any():
        j = int(np.flatnonzero(oob)[0])
        problems.append(f"parent[{j}]={int(parent[j])} out of range "
                        f"(n={n})")
        return problems  # later checks would index OOB
    ids = np.arange(n, dtype=np.int64)
    non_mono = linked & (parent <= ids)
    if non_mono.any():
        j = int(np.flatnonzero(non_mono)[0])
        problems.append(
            f"parent[{j}]={int(parent[j])} is not strictly later than its "
            f"kid (monotonicity violated — possible cycle)")
    if lo is not None:
        lo = np.asarray(lo, dtype=np.int64)
        total = int(forest.pst_weight.astype(np.int64).sum())
        if total != len(lo):
            problems.append(
                f"pst conservation violated: sum(pst)={total} != "
                f"{len(lo)} kept edge records")
        hist = np.bincount(lo, minlength=n)[:n] if len(lo) else \
            np.zeros(n, dtype=np.int64)
        if not np.array_equal(hist,
                              forest.pst_weight.astype(np.int64)):
            bad = np.flatnonzero(
                hist != forest.pst_weight.astype(np.int64))
            j = int(bad[0])
            problems.append(
                f"pst histogram mismatch at {len(bad)} node(s); first: "
                f"pst[{j}]={int(forest.pst_weight[j])} but {int(hist[j])} "
                f"records have lo={j}")
    return problems


def _ancestor_table(parent: np.ndarray, n: int) -> list[np.ndarray]:
    """Binary-lifting jump tables: levels[k][v] = 2^k-th ancestor of v,
    with a sentinel row (index n, for roots) that maps to itself."""
    up = np.empty(n + 1, dtype=np.int64)
    up[:n] = np.where(parent >= 0, parent, n)
    up[n] = n
    levels = [up]
    span = 1
    while span < n:
        levels.append(levels[-1][levels[-1]])
        span <<= 1
    return levels


def _walk_contains_lifted(parent: np.ndarray, lo: np.ndarray,
                          hi: np.ndarray, n: int,
                          chunk: int = 1 << 20) -> bool:
    """For every link, is hi on lo's root path?  Chunked pointer-doubling:
    O(E log n) gathers, ~chunk resident positions at a time."""
    if len(lo) == 0:
        return True
    levels = _ancestor_table(parent, n)
    for a in range(0, len(lo), chunk):
        cur = lo[a:a + chunk].astype(np.int64).copy()
        target = hi[a:a + chunk].astype(np.int64)
        for up in reversed(levels):
            step = up[cur]
            take = step <= target  # sentinel n > any target: roots stall
            np.copyto(cur, step, where=take)
        if not np.array_equal(cur, target):
            return False
    return True


def _walk_contains_loop(parent: np.ndarray, lo: np.ndarray,
                        hi: np.ndarray, n: int) -> bool:
    """The reference per-edge walk (jtree.cpp:260-276) — the slow oracle
    the vectorized walker is tested against."""
    for l, h in zip(lo.tolist(), hi.tolist()):
        cur = l
        steps = 0
        while cur < h:
            cur = parent[cur]
            steps += 1
            if cur < 0 or steps > n:
                return False
        if cur != h:
            return False
    return True


def is_valid_forest(forest: Forest, tail: np.ndarray, head: np.ndarray,
                    seq: np.ndarray, max_vid: int | None = None,
                    exact: str = "auto") -> bool:
    """The exact tier: fast invariants, then the per-edge root-path walk.

    ``exact``: "auto" (vectorized binary lifting; SHEEP_VALIDATE_LOOP=1
    flips to the loop), "lifted", or "loop" (the reference walker)."""
    if exact not in ("auto", "lifted", "loop"):
        raise ValueError(f"exact must be auto|lifted|loop, got {exact!r}")
    if exact == "auto":
        exact = "loop" if os.environ.get("SHEEP_VALIDATE_LOOP") == "1" \
            else "lifted"
    n = forest.n
    if n != len(seq):
        return False
    lo, hi = edges_to_positions(tail, head, seq, max_vid)
    if check_forest_fast(forest, lo, hi):
        return False
    parent = forest.parent.astype(np.int64)
    parent[forest.parent == INVALID_JNID] = -1
    tree = hi < n  # hi >= n: pst-only link (endpoint absent), no walk
    lo_t, hi_t = lo[tree], hi[tree]
    if exact == "loop":
        return _walk_contains_loop(parent, lo_t, hi_t, n)
    return _walk_contains_lifted(parent, lo_t, hi_t, n)
