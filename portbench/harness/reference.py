"""The plain reference: Sheep's sequence and elimination forest worked out
again from the edge records, in plain torch (and, for the tests, in
plain python).  It imports nothing of the program.

Semantics (Sheep, lib/sequence.h:52-63 and lib/jtree.cpp:34-55):

- the degree of a vid counts each record at both endpoints (a self-loop
  twice); the sequence holds the vids of nonzero degree in ascending
  degree, ties by ascending vid;
- a record {u, v} with positions pu != pv is the link (lo, hi) =
  (min, max); it adds 1 to ``pst[lo]``.  A vid the sequence leaves out
  has no position: its records count toward pst at the present endpoint
  and link nothing, and records with no present endpoint count nowhere;
- the parent of position x is the least position h > x joined to x
  through positions <= h (the threshold connectivity of the links), and
  a root has none (0xFFFFFFFF).

:func:`forest_union_find` is that definition as the union-find of the
original (links in ascending hi; the component's representative is its
largest position).  :func:`forest_lifting` computes the same forest with
whole-array operations, so that it runs on the card at full size: it
rewrites the link multiset, keeping its threshold connectivity, until
every position has at most one upward link, which is then its parent.
Two rewrites keep that connectivity: a position's upward links, sorted,
become a chain (a->b1, a->b2, ... becomes a->b1, b1->b2, ...), and a
link a->b moves to the furthest position below b on a's chain of least
upward links.  Each round raises the sum of the links' lower ends or
ends, so the loop ends.
"""

from __future__ import annotations

import numpy as np
import torch

ROOT = 0xFFFFFFFF


def degree_sequence(tail: torch.Tensor, head: torch.Tensor,
                    vid_slots: int) -> torch.Tensor:
    """Vids of nonzero degree by ascending (degree, vid), int64."""
    deg = torch.bincount(tail, minlength=vid_slots) \
        + torch.bincount(head, minlength=vid_slots)
    vids = torch.nonzero(deg).squeeze(1)
    order = torch.sort(deg[vids], stable=True).indices
    return vids[order]


def positions(seq: torch.Tensor, vid_slots: int) -> torch.Tensor:
    """vid -> position, -1 where the sequence leaves the vid out."""
    pos = torch.full((vid_slots,), -1, dtype=torch.int64, device=seq.device)
    pos[seq] = torch.arange(len(seq), dtype=torch.int64, device=seq.device)
    return pos


def links_and_pst(tail: torch.Tensor, head: torch.Tensor, pos: torch.Tensor,
                  n: int):
    """The tree links (lo < hi < n) and pst int64 [n] of the records."""
    absent = n  # sorts after every position
    pt = pos[tail]
    ph = pos[head]
    pt = torch.where(pt < 0, absent, pt)
    ph = torch.where(ph < 0, absent, ph)
    counted = pt != ph  # no self-loops, no records with both ends absent
    lo = torch.minimum(pt, ph)[counted]
    hi = torch.maximum(pt, ph)[counted]
    pst = torch.bincount(lo, minlength=n)[:n]
    tree = hi < n
    return lo[tree], hi[tree], pst


def _chain_and_dedupe(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Sort the links, drop repeats, and turn each position's sorted
    upward links into a chain.  Returns (lo, hi, rewritten)."""
    key = torch.unique(lo * (n + 1) + hi)
    lo = key // (n + 1)
    hi = key % (n + 1)
    same = lo[1:] == lo[:-1]
    if not bool(same.any()):
        return lo, hi, False
    chained = lo.clone()
    chained[1:] = torch.where(same, hi[:-1], lo[1:])
    return chained, hi, True


def _climb(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Move each link's lower end up its chain of least upward links, as
    far as it stays below hi (binary lifting over f^(2^k))."""
    up = torch.full((n + 1,), n, dtype=torch.int64, device=lo.device)
    up.scatter_reduce_(0, lo, hi, "amin")
    tables = [up]
    for _ in range(max(1, n.bit_length())):
        nxt = tables[-1][tables[-1]]
        if torch.equal(nxt, tables[-1]):
            break
        tables.append(nxt)
    for table in reversed(tables):
        cand = table[lo]
        lo = torch.where(cand < hi, cand, lo)
    return lo


def forest_lifting(lo: torch.Tensor, hi: torch.Tensor, n: int):
    """Parent int64 [n] (-1 for roots) of links lo < hi < n, and the
    number of rounds it took."""
    rounds = 0
    while True:
        rounds += 1
        lo, hi, rewritten = _chain_and_dedupe(lo, hi, n)
        if not rewritten:
            break
        lo = _climb(lo, hi, n)
    parent = torch.full((n,), -1, dtype=torch.int64, device=lo.device)
    parent[lo] = hi
    return parent, rounds


def forest_union_find(lo, hi, n: int) -> np.ndarray:
    """The same parents by the definition, one link at a time (plain
    python; for small graphs)."""
    parent = np.full(n, -1, dtype=np.int64)
    rep = list(range(n))

    def find(x):
        root = x
        while rep[root] != root:
            root = rep[root]
        while rep[x] != root:
            rep[x], x = root, rep[x]
        return root

    for i in np.argsort(np.asarray(hi), kind="stable"):
        h = int(hi[i])
        r = find(int(lo[i]))
        if r != h:
            parent[r] = h
            rep[r] = h
    return parent


def _u32(t: torch.Tensor) -> np.ndarray:
    """int64 values (-1 for none) as the program's uint32 arrays."""
    a = t.cpu().numpy()
    return np.where(a < 0, ROOT, a).astype(np.uint32)


def expected(tail: np.ndarray, head: np.ndarray, vid_slots: int, device,
             seq: np.ndarray | None = None) -> dict:
    """The reference's seq, parent and pst (uint32) for host records.
    ``seq`` None: the degree sequence; else that sequence."""
    t = torch.from_numpy(tail.astype(np.int64)).to(device)
    h = torch.from_numpy(head.astype(np.int64)).to(device)
    if seq is None:
        s = degree_sequence(t, h, vid_slots)
    else:
        s = torch.from_numpy(np.asarray(seq, np.int64)).to(device)
    n = len(s)
    lo, hi, pst = links_and_pst(t, h, positions(s, vid_slots), n)
    del t, h
    parent, _ = forest_lifting(lo, hi, n)
    return {"seq": _u32(s), "parent": _u32(parent), "pst": _u32(pst)}
