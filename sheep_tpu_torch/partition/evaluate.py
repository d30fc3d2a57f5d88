"""Partition quality evaluator, vectorized (port of
sheep_tpu/partition/evaluate.py).

Computes exactly the metrics of the reference's exhaustive evaluator
(lib/partition.cpp:428-521), but as dense segment/unique operations instead
of per-vertex hash-set scans ("evaluation is exhaustive, not efficient",
reference README:105 — here it is both):

  edges cut   undirected edges whose endpoints differ in part
  Vcom. vol   communication volume: per vertex, distinct neighbor parts
              beyond its own
  ECV(hash)   edge communication volume when each edge lives on the part of
              its hash-min endpoint (cormen_hash, partition.cpp:423-427)
  ECV(down)   edge CV under *downward* assignment — edge lives with its
              earlier-in-sequence endpoint (the paper's objective)
  ECV(up)     the reverse
  balances    max part load for each notion of load

Percentages follow the reference's printf quirk: the printed "(x%)" value is
the raw fraction of |E| (or of E/np, N/np for balances), not multiplied by
100 (partition.cpp:468-472,517-520).

The denominator |E| is the number of file records, matching LLAMA's
``getEdges()`` which includes self-loops ("XXX" note at partition.cpp:467).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_CORMEN_MULT = np.uint64(2654435769)  # floor(0.5*(sqrt(5)-1) * 2^32)


def cormen_hash(k: np.ndarray) -> np.ndarray:
    return (k.astype(np.uint64) * _CORMEN_MULT & np.uint64(0xFFFFFFFF)).astype(np.uint32)


#: the largest key space (bytes) :func:`_nunique_pairs` marks in a table
_KEY_TABLE_BYTES = 1 << 31


def _nunique_pairs(x: np.ndarray, y: np.ndarray, y_card: int) -> int:
    """Distinct (x, y) pairs, y in [0, y_card).  A byte per key of the
    key space marks the pairs seen: one scatter where the reference sorts
    (np.unique), the same count, in a time that does not grow with the
    number of parts as the sort's did at 2^26 records (PERF.md, section
    6).  Past ``_KEY_TABLE_BYTES`` it sorts."""
    key = x.astype(np.int64) * np.int64(y_card) + y.astype(np.int64)
    space = (int(x.max()) + 1) * y_card if len(x) else 0
    if space > _KEY_TABLE_BYTES:
        return len(np.unique(key))
    seen = np.zeros(space, dtype=bool)
    seen[key] = True
    return int(np.count_nonzero(seen))


@dataclass
class EvalReport:
    edges_cut: int
    vcom_vol: int
    ecv_hash: int
    ecv_down: int
    ecv_up: int
    vertex_balance: int
    hash_balance: int
    down_balance: int
    up_balance: int
    num_edges: int
    num_nodes: int
    num_parts: int

    def print(self, with_seq: bool = True) -> None:
        e = self.num_edges
        n = self.num_nodes
        np_ = max(self.num_parts, 1)
        # Balance denominators use truncating integer division like the
        # reference's size_t arithmetic (partition.cpp:470-472,518-520);
        # division by a zero denominator prints inf like C double division.
        div = lambda v, d: (v / d) if d else float("inf")
        print(f"edges cut: {self.edges_cut} ({div(self.edges_cut, e):f}%)")
        print(f"Vcom. vol: {self.vcom_vol} ({div(self.vcom_vol, e):f}%)")
        print(f"  balance: {self.vertex_balance} ({div(self.vertex_balance, n // np_):f}%)")
        print(f"ECV(hash): {self.ecv_hash} ({div(self.ecv_hash, e):f}%)")
        print(f"  balance: {self.hash_balance} ({div(self.hash_balance, e // np_):f}%)")
        if with_seq:
            print(f"ECV(down): {self.ecv_down} ({div(self.ecv_down, e):f}%)")
            print(f"  balance: {self.down_balance} ({div(self.down_balance, e // np_):f}%)")
            print(f"ECV(up)  : {self.ecv_up} ({div(self.ecv_up, e):f}%)")
            print(f"  balance: {self.up_balance} ({div(self.up_balance, e // np_):f}%)")


def evaluate_partition(parts: np.ndarray, tail: np.ndarray, head: np.ndarray,
                       seq: np.ndarray | None, num_parts: int,
                       max_vid: int | None = None,
                       file_edges: int | None = None) -> EvalReport:
    """``seq=None`` evaluates the sequence-free metrics only (the
    reference's evaluate(graph) overload, partition.cpp:428-473); the
    ECV(down)/(up) fields then come back zero — print with
    ``with_seq=False``."""
    from ..core.sequence import sequence_positions

    parts = parts.astype(np.int64)
    t = tail.astype(np.int64)
    h = head.astype(np.int64)
    E = file_edges if file_edges is not None else len(t)
    pos = None
    if seq is not None:
        pos = sequence_positions(seq, max_vid).astype(np.int64)

    deg_mask = np.zeros(len(parts), dtype=bool)
    deg_mask[t] = True
    deg_mask[h] = True
    n_active = int(deg_mask.sum())
    P = max(int(parts.max(initial=0)) + 1, 1)

    pt, ph = parts[t], parts[h]

    # edges cut: once per record, self-loops never differ
    edges_cut = int((pt != ph).sum())

    # directed-doubled views
    X = np.concatenate([t, h])
    Y = np.concatenate([h, t])
    pX = np.concatenate([pt, ph])
    pY = np.concatenate([ph, pt])

    # Vcom_vol: distinct (X, part[Y]) pairs, seeded with (X, part[X])
    active = np.nonzero(deg_mask)[0]
    vx = np.concatenate([X, active])
    vy = np.concatenate([pY, parts[active]])
    vcom = _nunique_pairs(vx, vy, P) - n_active

    # ECV(hash): per directed edge, part of the hash-smaller endpoint
    hX = cormen_hash(X.astype(np.uint32)).astype(np.int64)
    hY = cormen_hash(Y.astype(np.uint32)).astype(np.int64)
    hash_part = np.where(hX < hY, pX, pY)
    ecv_hash = _nunique_pairs(X, hash_part, P) - n_active
    # hash balance: once per undirected edge (the directed X<Y filter),
    # self-loops skipped; record orientation must not matter
    und = t != h
    a = np.minimum(t[und], h[und])
    b = np.maximum(t[und], h[und])
    ha = cormen_hash(a.astype(np.uint32)).astype(np.int64)
    hb = cormen_hash(b.astype(np.uint32)).astype(np.int64)
    und_hash_part = np.where(ha < hb, parts[a], parts[b])
    hash_balance = int(np.bincount(und_hash_part, minlength=P).max(initial=0))

    # ECV(down)/(up): part of the earlier/later-in-sequence endpoint
    ecv_down = ecv_up = down_balance = up_balance = 0
    if pos is not None:
        posX = pos[X]
        posY = pos[Y]
        down_part = np.where(posX < posY, pX, pY)
        up_part = np.where(posX > posY, pX, pY)
        ecv_down = _nunique_pairs(X, down_part, P) - n_active
        ecv_up = _nunique_pairs(X, up_part, P) - n_active
        down_balance = int(np.bincount(pX[posX < posY], minlength=P).max(initial=0))
        up_balance = int(np.bincount(pX[posX > posY], minlength=P).max(initial=0))

    vertex_balance = int(np.bincount(parts[active], minlength=P).max(initial=0))

    return EvalReport(
        edges_cut=edges_cut,
        vcom_vol=vcom,
        ecv_hash=ecv_hash,
        ecv_down=ecv_down,
        ecv_up=ecv_up,
        vertex_balance=vertex_balance,
        hash_balance=hash_balance,
        down_balance=down_balance,
        up_balance=up_balance,
        num_edges=E,
        num_nodes=n_active,
        num_parts=num_parts,
    )


def evaluate_partition_streamed(parts: np.ndarray, blocks_factory,
                                pos: np.ndarray | None, num_parts: int,
                                file_edges: int,
                                impl: str = "auto") -> EvalReport:
    """Exact evaluator in O(n) memory for graphs whose doubled key arrays
    would not fit in host RAM (the in-memory path peaks at ~50 GB for
    twitter-2010; reference anchor lib/partition.cpp:428-521).

    The distinct-(vertex, part) counts behind Vcom/ECV are computed with
    per-vertex part-set *bitmaps*: one uint64 per vertex covers a window of
    64 parts, edges stream through in blocks, and windows repeat for
    num_parts > 64 — ceil(P/64) passes over the edge stream, each O(n)
    memory.  Results are bit-identical to :func:`evaluate_partition`.

    ``blocks_factory``: zero-arg callable returning a fresh iterator of
    (tail, head) uint32 blocks (e.g. ``lambda: iter_dat_blocks(path, B)``).
    ``pos``: vid -> sequence position table, or None for the sequence-free
    overload.  ``parts`` must cover every vid in the stream.  ``impl``:
    auto|native|python: "auto" and "native" run each block in the native
    library (sheep_eval_block), "python" runs the numpy body, the oracle
    the tests hold the library against.
    """
    parts = np.ascontiguousarray(parts, dtype=np.int64)
    n = len(parts)
    P = max(int(parts.max(initial=0)) + 1, 1)

    from ..core.forest import native_or_none
    native = native_or_none(impl)
    pos32 = None
    if pos is not None and native is not None:
        pos32 = np.ascontiguousarray(pos, dtype=np.uint32)

    deg_mask = np.zeros(n, dtype=np.uint8)
    edges_cut = 0
    part_loads = np.zeros(P, dtype=np.int64)          # vertex balance
    hash_loads = np.zeros(P, dtype=np.int64)          # undirected hash loads
    down_loads = np.zeros(P, dtype=np.int64)
    up_loads = np.zeros(P, dtype=np.int64)
    vcom = ecv_hash = ecv_down = ecv_up = 0

    for w0 in range(0, P, 64):
        first_window = w0 == 0
        m_vcom = np.zeros(n, dtype=np.uint64)
        m_hash = np.zeros(n, dtype=np.uint64)
        m_down = np.zeros(n, dtype=np.uint64) if pos is not None else None
        m_up = np.zeros(n, dtype=np.uint64) if pos is not None else None

        def scatter_bits(mask, X, p):
            sel = (p >= w0) & (p < w0 + 64)
            np.bitwise_or.at(mask, X[sel],
                             np.uint64(1) << (p[sel] - w0).astype(np.uint64))

        for tail, head in blocks_factory():
            if native is not None:
                # one C pass per block updates every window bitmap / load
                # counter in place, bit-identical to the numpy body
                # below (whose np.bitwise_or.at is unbuffered)
                edges_cut += native.eval_block(
                    tail, head, parts, pos32, w0, first_window,
                    m_vcom, m_hash, m_down, m_up, deg_mask,
                    hash_loads, down_loads, up_loads, P)
                continue
            t = tail.astype(np.int64)
            h = head.astype(np.int64)
            pt, ph = parts[t], parts[h]
            if first_window:
                deg_mask[t] = 1
                deg_mask[h] = 1
                edges_cut += int((pt != ph).sum())

            for X, Y, pX, pY in ((t, h, pt, ph), (h, t, ph, pt)):
                scatter_bits(m_vcom, X, pY)
                hX = cormen_hash(X.astype(np.uint32)).astype(np.int64)
                hY = cormen_hash(Y.astype(np.uint32)).astype(np.int64)
                scatter_bits(m_hash, X, np.where(hX < hY, pX, pY))
                if pos is not None:
                    posX, posY = pos[X], pos[Y]
                    scatter_bits(m_down, X, np.where(posX < posY, pX, pY))
                    scatter_bits(m_up, X, np.where(posX > posY, pX, pY))

            if first_window:
                und = t != h
                a = np.minimum(t[und], h[und])
                b = np.maximum(t[und], h[und])
                ha = cormen_hash(a.astype(np.uint32)).astype(np.int64)
                hb = cormen_hash(b.astype(np.uint32)).astype(np.int64)
                hash_loads += np.bincount(
                    np.where(ha < hb, parts[a], parts[b]), minlength=P)
                if pos is not None:
                    post, posh = pos[t], pos[h]
                    down_loads += np.bincount(pt[post < posh], minlength=P)
                    up_loads += np.bincount(pt[post > posh], minlength=P)
                    down_loads += np.bincount(ph[posh < post], minlength=P)
                    up_loads += np.bincount(ph[posh > post], minlength=P)

        # Seed Vcom with each active vertex's own part (within this window).
        active = np.nonzero(deg_mask)[0]
        own = parts[active]
        sel = (own >= w0) & (own < w0 + 64)
        np.bitwise_or.at(m_vcom, active[sel],
                         np.uint64(1) << (own[sel] - w0).astype(np.uint64))

        vcom += int(np.bitwise_count(m_vcom).sum())
        ecv_hash += int(np.bitwise_count(m_hash).sum())
        if pos is not None:
            ecv_down += int(np.bitwise_count(m_down).sum())
            ecv_up += int(np.bitwise_count(m_up).sum())

    active = np.nonzero(deg_mask)[0]
    n_active = len(active)
    part_loads = np.bincount(parts[active], minlength=P)

    return EvalReport(
        edges_cut=edges_cut,
        vcom_vol=vcom - n_active,
        ecv_hash=ecv_hash - n_active,
        ecv_down=(ecv_down - n_active) if pos is not None else 0,
        ecv_up=(ecv_up - n_active) if pos is not None else 0,
        vertex_balance=int(part_loads.max(initial=0)),
        hash_balance=int(hash_loads.max(initial=0)),
        down_balance=int(down_loads.max(initial=0)),
        up_balance=int(up_loads.max(initial=0)),
        num_edges=file_edges,
        num_nodes=n_active,
        num_parts=num_parts,
    )
