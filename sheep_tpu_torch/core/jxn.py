"""Treewidth / fill-in ("jxn") mode — the parameterized insert path (port
of sheep_tpu/core/jxn.py).

Reference semantics (lib/jtree.cpp:65-231, lib/jnode.h:158-253): when kids /
pst / jxn tables are requested, each inserted vertex X additionally records

  kids(X)  the subtree roots X adopts (adoption deferred until the insert
           is known to succeed),
  pst(X)   X's not-yet-inserted neighbor vids, sorted and deduplicated
           (pst_weight still counts edge multiplicity),
  jxn(X)   the elimination fill-in: union of the kids' jxns plus pst(X),
           minus X itself — sorted by vid.

``width(X) = 1 + |jxn(X)|`` (lib/jnode.h:258-260); the max over the tree is
an upper bound on treewidth + 1 for the given elimination sequence.  A
vertex whose postorder multiplicity or merged jxn would exceed
``width_limit`` is rejected and deferred to the tail (``wide_seq``,
jtree.cpp:107-109,139-140).  Deferred and unvisited vertices then form a
root chain whose jxns are the trivially-shrinking remaining-vertex set
(jtree.cpp:152-222).  ``find_max_width`` stops early once the running max
width can no longer be exceeded; ``do_rooting`` switches to the chain as
soon as a node's width equals the remaining-vertex count.

Deviation from the reference, documented: on a width-limit rejection the
reference has already scribbled ``parent(root) = current`` for met kids and
cannot revoke it (the "XXX cannot be revoked" comment at jtree.cpp:99 only
defers union-find, not the parent writes), leaving stale parent pointers on
roots the deleted jnid never adopted.  Here the rejection is atomic — no
state leaks — which is the evident intent.

This is a host-side feature in the reference and stays host-side here: the
dynamic, data-dependent set unions have no fixed shape for the card, and
the default build never builds these tables (SURVEY §7 structural
insight).  The module loads no torch; with ``-i``/``-r`` the CLI sorts
degrees on the card first and then runs this insert on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import INVALID_JNID
from .forest import Forest


@dataclass
class JxnOptions:
    """Mirror of JTree::Options (lib/jtree.h:71-108)."""

    verbose: bool = False
    make_pad: bool = True
    make_kids: bool = False
    make_pst: bool = False
    make_jxn: bool = False
    memory_limit: int = 1 << 30
    width_limit: int = 0  # 0 = unlimited (CLI -w unset)
    find_max_width: bool = False
    # The reference also declares ``rooting_limit`` (lib/jtree.h:84) but
    # never reads it outside the option-validity matrix (jtree.h:106) — it
    # is dead there, so it is deliberately not mirrored here.
    do_rooting: bool = False

    def effective_width_limit(self) -> int:
        return self.width_limit if self.width_limit > 0 else (1 << 62)


@dataclass
class JxnTree:
    """Forest plus the optional kids/pst/jxn tables, all jnid-indexed."""

    forest: Forest
    seq: np.ndarray                      # jnid -> vid (effective order)
    kids: list[list[int]] | None = None
    pst: list[np.ndarray] | None = None  # sorted dedup'd vids
    jxn: list[np.ndarray] | None = None  # sorted vids

    @property
    def widths(self) -> np.ndarray:
        """1 + |jxn| where jxn exists, else 1 + pst_weight."""
        n = self.forest.n
        w = 1 + self.forest.pst_weight.astype(np.int64)
        if self.jxn is not None:
            for i, jx in enumerate(self.jxn):
                if jx is not None:
                    w[i] = 1 + len(jx)
        return w


class _Csr:
    """Host CSR adjacency of the undirected-doubled graph."""

    def __init__(self, tail: np.ndarray, head: np.ndarray, n: int):
        src = np.concatenate([tail, head]).astype(np.int64)
        dst = np.concatenate([head, tail]).astype(np.int64)
        order = np.argsort(src, kind="stable")
        self.dst = dst[order]
        self.offs = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.offs, src + 1, 1)
        np.cumsum(self.offs, out=self.offs)
        self.deg = np.diff(self.offs)

    def neighbors(self, v: int) -> np.ndarray:
        return self.dst[self.offs[v]:self.offs[v + 1]]


def _find(uf: list[int], x: int) -> int:
    root = x
    while uf[root] != root:
        root = uf[root]
    while uf[x] != root:
        uf[x], x = root, uf[x]
    return root


def build_jxn_tree(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                   opts: JxnOptions,
                   num_vertices: int | None = None) -> JxnTree:
    n_vid = num_vertices
    if n_vid is None:
        mx = int(max(tail.max(initial=0), head.max(initial=0))) if len(tail) else -1
        n_vid = max(mx + 1, int(seq.max(initial=0)) + 1 if len(seq) else 0)
    csr = _Csr(tail, head, n_vid)
    wlimit = opts.effective_width_limit()

    index = np.full(n_vid, INVALID_JNID, dtype=np.uint32)
    parent: list[int] = []
    pst_weight: list[int] = []
    out_seq: list[int] = []
    kids_tbl: list[list[int]] = []
    pst_tbl: list[np.ndarray] = []
    jxn_tbl: list[np.ndarray | None] = []
    uf: list[int] = []
    mem_used = 0

    def check_mem(extra_items: int) -> None:
        nonlocal mem_used
        mem_used += 4 * extra_items
        if mem_used > opts.memory_limit:
            raise MemoryError(
                f"pst/jxn tables exceed memory_limit={opts.memory_limit}")

    wide_seq: list[int] = []
    stopped_at: int | None = None  # seq index where normal insertion stopped
    current_width = 0
    seq_list = [int(v) for v in seq]

    for si, X in enumerate(seq_list):
        if not opts.make_pad and csr.deg[X] == 0:
            continue
        current = len(parent)
        pw = 0
        pvids: list[int] = []
        ks: list[int] = []
        ks_seen: set[int] = set()  # O(1) met-root dedup (meetKid's check)
        fail = False
        for nbr in csr.neighbors(X).tolist():
            nid = int(index[nbr])
            if nid != INVALID_JNID:
                r = _find(uf, nid)
                if r not in ks_seen:
                    ks_seen.add(r)
                    ks.append(r)
            elif nbr != X:
                pw += 1
                if pw > wlimit:
                    fail = True
                    break
                pvids.append(nbr)
        jx: np.ndarray | None = None
        if not fail:
            pvids_u = np.unique(np.asarray(pvids, dtype=np.int64))
            if opts.make_jxn:
                pieces = [jxn_tbl[k] for k in ks if jxn_tbl[k] is not None
                          and len(jxn_tbl[k])]
                pieces.append(pvids_u)
                jx = np.unique(np.concatenate(pieces)) if pieces else \
                    np.empty(0, dtype=np.int64)
                jx = jx[jx != X]
                if len(jx) > wlimit:
                    fail = True
        if fail:
            # The reference runs the find_max_width bound check on FAILED
            # inserts too, before X joins wide_seq (jtree.cpp:130-136).
            if opts.find_max_width and \
                    current_width >= len(wide_seq) + (len(seq_list) - si):
                return _finish(parent, pst_weight, out_seq, kids_tbl,
                               pst_tbl, jxn_tbl, opts)
            wide_seq.append(X)
            continue

        # Commit (atomic)
        parent.append(INVALID_JNID)
        pst_weight.append(pw)
        out_seq.append(X)
        uf.append(current)
        for r in ks:
            parent[r] = current
            uf[r] = current
        kids_tbl.append(ks)
        if opts.make_pst:
            check_mem(len(pvids_u))
            pst_tbl.append(pvids_u)
        if opts.make_jxn:
            check_mem(len(jx))
        jxn_tbl.append(jx)
        index[X] = current

        # ``remaining`` counts X itself plus everything still to insert,
        # matching std::distance(seq_itr, cend()) + wide_seq.size() at
        # jtree.cpp:134,141 (seq_itr still points at X there).
        remaining = len(wide_seq) + (len(seq_list) - si)
        if opts.find_max_width:
            current_width = max(current_width, 1 + (len(jx) if jx is not None
                                                    else pw))
            if current_width >= remaining:
                return _finish(parent, pst_weight, out_seq, kids_tbl, pst_tbl,
                               jxn_tbl, opts)
        # width falls back to 1 + pst_weight when jxn tables are off
        # (lib/jnode.h:258-260), so rooting works in pst-only mode too.
        cur_w = 1 + (len(jx) if jx is not None else pw)
        if opts.do_rooting and cur_w == remaining:
            stopped_at = si + 1
            break

    # Tail phase: deferred + unvisited vertices become a root chain.
    rest = wide_seq + (seq_list[stopped_at:] if stopped_at is not None else [])
    for ti, X in enumerate(rest):
        current = len(parent)
        parent.append(INVALID_JNID)
        uf.append(current)
        out_seq.append(X)
        ks = []
        if ti == 0:
            for kid in range(current):
                if parent[kid] == INVALID_JNID:
                    parent[kid] = current
                    uf[kid] = current
                    ks.append(kid)
        else:
            prev = current - 1
            parent[prev] = current
            uf[prev] = current
            ks.append(prev)
        kids_tbl.append(ks)
        pw = 0
        pvids = []
        for nbr in csr.neighbors(X).tolist():
            if index[nbr] == INVALID_JNID and nbr != X:
                pw += 1
                pvids.append(nbr)
        pst_weight.append(pw)
        if opts.make_pst:
            pvids_u = np.unique(np.asarray(pvids, dtype=np.int64))
            # the reference's arena charges tail-phase pst allocations too
            # (newPst -> JDataTable, jtree.cpp:168,177)
            check_mem(len(pvids_u))
            pst_tbl.append(pvids_u)
        # jxn is the trivially-shrinking remaining set (jtree.cpp:182-186);
        # only materialized (and charged against memory_limit) in jxn mode.
        if opts.make_jxn:
            jx = np.sort(np.asarray(rest[ti + 1:], dtype=np.int64))
            check_mem(len(jx))
            jxn_tbl.append(jx)
        else:
            jxn_tbl.append(None)
        index[X] = current
        if ti == 0 and opts.find_max_width:
            return _finish(parent, pst_weight, out_seq, kids_tbl, pst_tbl,
                           jxn_tbl, opts)

    return _finish(parent, pst_weight, out_seq, kids_tbl, pst_tbl, jxn_tbl,
                   opts)


def _finish(parent, pst_weight, out_seq, kids_tbl, pst_tbl, jxn_tbl,
            opts: JxnOptions) -> JxnTree:
    forest = Forest(np.asarray(parent, dtype=np.uint32),
                    np.asarray(pst_weight, dtype=np.uint32))
    return JxnTree(
        forest=forest,
        seq=np.asarray(out_seq, dtype=np.uint32),
        kids=kids_tbl if opts.make_kids else None,
        pst=pst_tbl if opts.make_pst else None,
        jxn=jxn_tbl if opts.make_jxn else None,
    )


def build_forest_jxn(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
                     opts: JxnOptions, impl: str = "auto"):
    """CLI adapter: returns (forest, effective_seq, widths-or-None).

    ``impl`` "auto" or "native" runs the C++ twin (csrc/sheep_native.cpp
    sheep_jxn_build; the library raises if it cannot build) — the
    reference runs -kejx on million-vertex graphs, far beyond the python
    oracle's reach.  ``impl="python"`` runs the oracle
    (build_jxn_tree), which also materializes the kids/pst/jxn tables
    for tests and library callers.
    """
    from .forest import native_or_none
    native = native_or_none(impl)
    if native is not None:
        n_vid = int(max(tail.max(initial=0), head.max(initial=0))) \
            if len(tail) else -1
        n_vid = max(n_vid + 1, int(seq.max(initial=0)) + 1 if len(seq) else 0)
        parent, pst, out_seq, widths = native.jxn_build(
            tail, head, seq, n_vid, opts.width_limit, opts.memory_limit,
            opts.make_pad, opts.make_pst, opts.make_jxn,
            opts.find_max_width, opts.do_rooting)
        forest = Forest(parent, pst)
        return forest, out_seq, (widths if opts.make_jxn else None)
    tree = build_jxn_tree(tail, head, seq, opts)
    widths = tree.widths if opts.make_jxn else None
    return tree.forest, tree.seq, widths
