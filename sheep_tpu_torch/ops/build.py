"""Single-device build: edges -> (sequence, elimination forest).

Port of sheep_tpu/ops/build.py.  ``build_graph_hybrid`` is the flagship
path: the device runs the phases that scale with E (degree histogram,
(degree, vid) sort, link mapping, and reduce rounds that kill the
duplicate and star-collapsible links), then the remaining links move to
the host and the exact sequential union-find (``native``) finishes.
Sound because every round preserves threshold connectivity, and the
forest is a function of threshold connectivity alone.

This port carries the reference's serial handoff tail (its
``SHEEP_STREAM_HANDOFF=0 SHEEP_OVERLAP_HANDOFF=0`` arm, which it documents
as bit-identical to its streamed default): one fetch of the reduced
links, one fold.  Where the reference branches on the JAX platform, the
port branches on ``device.type``; the env knobs keep their meanings.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..convert import edges_to_device
from ..core.forest import Forest
from .forest import (_np, _to_forest, forest_fixpoint_hosted,
                     parent_from_links, pst_weights, reduce_links_hosted)
from .sort import (degree_histogram, degree_order, edge_links,
                   given_seq_links)


def prepare_links(tail: torch.Tensor, head: torch.Tensor, n: int,
                  with_pst: bool = True):
    """Phases before the fixpoint: degree histogram, (degree, vid) sort,
    edge->link mapping, pst segment-sum.  Returns (seq, pos, num_active,
    lo, hi, pst); pst counts the ORIGINAL links (the reduce rewrites lo)
    and is None when ``with_pst`` is False."""
    deg = degree_histogram(tail, head, n)
    seq, pos, m = degree_order(deg)
    lo, hi = edge_links(tail, head, pos, n)
    pst = pst_weights(lo, n) if with_pst else None
    return seq, pos, m, lo, hi, pst


def _finish(seq, m, parent, pst):
    m = int(m)
    seq = _as_u32(np.ascontiguousarray(_np(seq)[:m]))
    # trimmed to the m active slots; parents of active nodes are < m
    return seq, _to_forest(_np(parent)[:m], _np(pst)[:m], m)


def _num_vertices(tail, head, num_vertices) -> int:
    if num_vertices is not None:
        return num_vertices
    if not len(tail):
        return 0
    return int(max(tail.max(), head.max())) + 1


def _device_edges(tail, head, device):
    if isinstance(tail, torch.Tensor):
        return tail.to(device, torch.int32), head.to(device, torch.int32)
    return edges_to_device(tail, head, device)


def build_graph_device(tail, head, num_vertices: int | None = None,
                       device=None):
    """Device build through the host-orchestrated chunked fixpoint:
    returns (seq uint32 [m], Forest over m).  ``device`` None is CUDA."""
    device = resolve_device(device)
    n = _num_vertices(tail, head, num_vertices)
    if n == 0:
        return np.empty(0, np.uint32), Forest(
            np.empty(0, np.uint32), np.empty(0, np.uint32))
    t, h = _device_edges(tail, head, device)
    seq, _, m, lo, hi, pst = prepare_links(t, h, n)
    parent, _ = forest_fixpoint_hosted(lo, hi, n)
    return _finish(seq, m, parent, pst)


def _host_seq_pst(tail_np: np.ndarray, head_np: np.ndarray, n: int,
                  seq: np.ndarray | None = None):
    """Host-side (seq, pst) identical to prepare_links' outputs: same
    order (degree asc, vid asc) and same pst (one count per non-self-loop
    record at its earlier-in-sequence endpoint, absent heads included).
    A given ``seq`` replaces the degree sort.  Block-wise gathers keep the
    peak at a few int arrays of one block."""
    from ..core.sequence import degree_sequence, sequence_positions

    seq_h = degree_sequence(tail_np, head_np, n) if seq is None \
        else np.asarray(seq, dtype=np.uint32)
    pos = sequence_positions(seq_h, n - 1)
    pst = np.zeros(n, np.int64)
    block = 1 << 24
    for s in range(0, len(tail_np), block):
        # absent vids carry INVALID (0xFFFFFFFF) >= n, so min() picks the
        # present endpoint and the lo < n filter drops both-absent pairs
        pt = pos[tail_np[s:s + block]].astype(np.int64)
        ph = pos[head_np[s:s + block]].astype(np.int64)
        lo = np.minimum(pt, ph)
        live = (pt != ph) & (lo < n)
        pst += np.bincount(lo[live], minlength=n)[:n]
    return seq_h, pst.astype(np.uint32)


def build_graph_hybrid(tail, head, num_vertices: int | None = None,
                       handoff_factor: int | None = None,
                       host_edges: tuple[np.ndarray, np.ndarray] | None = None,
                       seq: np.ndarray | None = None,
                       perf: dict | None = None, device=None):
    """Flagship build: device reduction + native union-find tail.
    Returns (seq uint32 [m], Forest over m), bit-identical to the oracle.

    ``device`` None is CUDA (RuntimeError without it); pass "cpu" to run
    on the CPU.  ``handoff_factor``: hand off once at most factor * n live
    links remain (SHEEP_HANDOFF_FACTOR; default 3 on CUDA, 8 on the CPU).
    ``host_edges``: the same records as host numpy arrays; with them seq
    and pst are recomputed on the host while the device reduces (numpy
    inputs serve as their own host copy on CUDA).  ``seq``: a given
    elimination order (edges to vids outside it count toward pst, never
    the tree).  ``perf``: a dict that receives loop_s, fetch_tail_s,
    pst_wait_s, fold_s, handoff_links, packed_handoff, rounds, live and
    prefetch_s (the seq/pst prefetch thread's own time).
    """
    device = resolve_device(device)
    if handoff_factor is None:
        handoff_factor = default_handoff_factor(device)
    n = _num_vertices(tail, head, num_vertices)
    if seq is not None and len(seq):
        n = max(n, int(np.asarray(seq).max()) + 1)
    if n == 0:
        return np.empty(0, np.uint32), Forest(
            np.empty(0, np.uint32), np.empty(0, np.uint32))
    if host_edges is None and device.type == "cuda" \
            and isinstance(tail, np.ndarray) and isinstance(head, np.ndarray):
        # the reference's accelerator default, made for a byte-bound
        # link: the host copy replaces the 2n*4B seq/pst fetch.  On an
        # H100 over PCIe the host recompute costs more than that fetch.
        host_edges = (tail, head)
    t, h = _device_edges(tail, head, device)
    given_seq = None
    _lazy_pst = None
    if seq is not None:
        # given order: no histogram, no device sort
        given_seq = np.asarray(seq, dtype=np.uint32)
        lo, hi, pst = given_seq_links(t, h, given_seq, n,
                                      with_pst=host_edges is None)
        m = len(given_seq)
        dev_seq = None
        if pst is None:
            # pst counts the pre-dead-mask lo, so the rare prefetch
            # failure reruns the mapping with the scatter included
            def _lazy_pst():
                return given_seq_links(t, h, given_seq, n)[2]
    else:
        dev_seq, _, m, lo, hi, pst = prepare_links(
            t, h, n, with_pst=host_edges is None)
        if pst is None:
            orig_lo = lo

            def _lazy_pst():
                return pst_weights(orig_lo, n)
    seq = given_seq if given_seq is not None else dev_seq
    # seq/pst overlap the reduce rounds on a second thread: recomputed
    # from the host edge copy, or fetched from the device
    fetched: dict = {}

    def _prefetch():
        t0 = time.perf_counter()
        try:
            if host_edges is not None:
                t_np, h_np = host_edges
                fetched["seq"], fetched["pst"] = _host_seq_pst(
                    t_np, h_np, n, seq=given_seq)
                fetched["m"] = len(fetched["seq"])
            else:
                fetched["seq"] = _np(seq)
                if pst is not None:
                    fetched["pst"] = _np(pst)
        except Exception:  # fall back to the synchronous fetch below
            fetched.clear()
        if perf is not None:
            perf["prefetch_s"] = round(time.perf_counter() - t0, 4)

    pre = threading.Thread(target=_prefetch, daemon=True)
    pre.start()

    def _pst_resolved():
        if "pst" in fetched:
            return fetched["pst"]
        return pst if pst is not None else _lazy_pst()

    def _pst_after_fetch():
        # resolved only after the link fetch, so the prefetch overlaps it
        pre.join()
        return _as_u32(_np(_pst_resolved()))

    res = reduce_and_finish_native(
        lo, hi, n, stop_live=handoff_factor * n,
        handoff_input=handoff_input_ok(device), pst_h=_pst_after_fetch,
        perf=perf)
    if res[0] == "device":  # converged before the handoff threshold
        _, a, b, live, rounds = res
        pre.join()
        parent = parent_from_links(a, b, n)
        return _finish(fetched.get("seq", seq), fetched.get("m", m), parent,
                       _pst_resolved())
    _, parent_h, pst_out, live, rounds = res
    m = int(fetched.get("m", m))
    seq_np = _as_u32(np.ascontiguousarray(_np(fetched.get("seq", seq))[:m]))
    return seq_np, Forest(parent_h[:m].copy(), pst_out[:m].copy())


def handoff_input_ok(device: torch.device) -> bool:
    """The immediate-handoff gate: skip the device dedupe rounds only
    where the device->host copy is free (the CPU); on the card the fetch
    is a real transfer and the rounds shrink it first."""
    return device.type == "cpu"


def default_handoff_factor(device: torch.device) -> int:
    """Handoff threshold, stop_live = factor * n (SHEEP_HANDOFF_FACTOR
    overrides): 8 on the CPU, where the transfer is free; 3 on CUDA, the
    reference's accelerator default."""
    default = "8" if device.type == "cpu" else "3"
    return int(os.environ.get("SHEEP_HANDOFF_FACTOR", default))


def pack_handoff(n: int, device: torch.device) -> bool:
    """The 6-byte link packing policy of the handoff fetch
    (SHEEP_PACK_HANDOFF overrides): on for CUDA, off on the CPU; packing
    needs n < 2^24."""
    pack = os.environ.get("SHEEP_PACK_HANDOFF", "")
    if pack == "":
        pack = "0" if device.type == "cpu" else "1"
    return pack == "1" and n < (1 << 24)


def fetch_links_host(lo: torch.Tensor, hi: torch.Tensor, live: int, n: int):
    """The link-fetch policy: a 64K-granular cut of the live prefix,
    6-byte packing per :func:`pack_handoff`, dead-sentinel filter.
    Returns (lo_h, hi_h int32 numpy arrays, packed)."""
    cut = min(int(lo.shape[0]), -(-live // (1 << 16)) * (1 << 16))
    packed = pack_handoff(n, lo.device)
    if packed:
        from .forest import pack_links_6b, unpack_links_6b
        buf = pack_links_6b(lo[:cut], hi[:cut]).cpu().numpy()[:live]
        lo_h, hi_h = unpack_links_6b(buf)
    else:
        lo_h = lo[:cut].cpu().numpy()[:live]
        hi_h = hi[:cut].cpu().numpy()[:live]
    keep = lo_h < n  # a few scattered dead slots may remain in the prefix
    return lo_h[keep], hi_h[keep], packed


def _as_u32(a: np.ndarray) -> np.ndarray:
    """uint32 without a copy where possible (contiguous int32 reinterprets,
    exact under the nonnegative-int32 contract)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return a
    if a.dtype == np.int32 and a.flags["C_CONTIGUOUS"]:
        return a.view(np.uint32)
    return a.astype(np.uint32, copy=False)


def reduce_and_fetch_links(lo, hi, n: int, stop_live: int,
                           handoff_input: bool = False, perf=None):
    """The reduce + serial fetch middle of the hybrid.  Returns (kind, a,
    b, live, rounds): kind "device" (converged before the threshold; a/b
    are device link tensors) or "host" (a/b are the fetched, lo<n-filtered
    host link arrays).  ``perf`` gains loop_s, fetch_tail_s, rounds, live
    and, on a handoff, handoff_links and packed_handoff."""
    t0 = time.perf_counter()
    lo, hi, live, rounds, converged = reduce_links_hosted(
        lo, hi, n, stop_live=stop_live, handoff_input=handoff_input)
    t1 = time.perf_counter()
    if perf is not None:
        perf["loop_s"] = round(t1 - t0, 4)
        perf["rounds"] = int(rounds)
        perf["live"] = int(live)
    if converged:
        if perf is not None:
            perf["fetch_tail_s"] = 0.0
        return "device", lo, hi, int(live), rounds
    lo_h, hi_h, packed = fetch_links_host(lo, hi, int(live), n)
    if perf is not None:
        perf["fetch_tail_s"] = round(time.perf_counter() - t1, 4)
        perf["handoff_links"] = int(len(lo_h))
        perf["packed_handoff"] = packed
    return "host", lo_h, hi_h, int(live), rounds


def reduce_and_finish_native(lo, hi, n: int, stop_live: int,
                             handoff_input: bool = False, pst_h=None,
                             perf=None):
    """Reduce + serial handoff + native fold.  Returns ("device", lo, hi,
    live, rounds) when the loop converged before the threshold, else
    ("forest", parent, pst, live, rounds) with parent/pst uint32 [n].
    ``pst_h``: the prep-time pst, an array or a zero-arg callable resolved
    after the fetch.  ``perf`` also gains pst_wait_s (resolving pst_h)
    and fold_s (the fold alone), both added into fetch_tail_s."""
    kind, a, b, live, rounds = reduce_and_fetch_links(
        lo, hi, n, stop_live=stop_live, handoff_input=handoff_input,
        perf=perf)
    if kind == "device":
        return "device", a, b, live, rounds
    t0 = time.perf_counter()
    if callable(pst_h):
        pst_h = pst_h()
    t1 = time.perf_counter()
    parent, pst = finish_native_host(a, b, n, pst_h)
    if perf is not None:
        perf["pst_wait_s"] = round(t1 - t0, 4)
        perf["fold_s"] = round(time.perf_counter() - t1, 4)
        perf["fetch_tail_s"] = round(
            perf.get("fetch_tail_s", 0.0) + perf["pst_wait_s"]
            + perf["fold_s"], 4)
    return "forest", parent, pst, live, rounds


def finish_native_host(lo_h: np.ndarray, hi_h: np.ndarray, n: int, pst_h):
    """Exact union-find tail on host link arrays: returns (parent, pst)
    uint32 [n].  pst_h may be a zero-arg callable, resolved here."""
    from .. import native

    if callable(pst_h):
        pst_h = pst_h()
    return native.build_forest_links(_as_u32(lo_h), _as_u32(hi_h), n, pst_h)


def handoff_finish_native(lo, hi, live: int, n: int, pst_h):
    """Fetch a reduced link set and finish with the exact sequential
    union-find: returns (parent, pst) uint32 [n]."""
    lo_h, hi_h, _ = fetch_links_host(lo, hi, live, n)
    return finish_native_host(lo_h, hi_h, n, pst_h)
