"""ctypes binding of the port's native host runtime
(``csrc/sheep_native.cpp``, the port's copy of the reference's
``sheep_tpu/native/src/sheep_native.cpp``), built with g++ at first use
into ``_build/libsheep_torch_native.so``.

The library holds the elimination-forest fold (monolithic, resumable,
fused from edges; plain, cache-blocked and OpenMP-threaded), the degree
histogram and the fused degree sort, the edge-to-link map, the treewidth
mode's parameterized insert, the forward tree partition, FENNEL and the
streamed evaluator's block.  Its own name
and path keep it apart from the reference's ``libsheep_native.so`` when
both load in one process (ctypes loads with ``RTLD_LOCAL``).

The port has no numpy fallback for a missing library: a failed build
raises with the compiler's output.  ctypes releases the GIL for each
call, so a fold overlaps the handoff's fetch thread.

Threads: ``SHEEP_NATIVE_THREADS`` (exported by the runtime driver from
the governor's plan), ``SHEEP_NATIVE_OVERSUB``,
``SHEEP_NATIVE_THREAD_FLOOR`` and ``SHEEP_NATIVE_BLOCKED`` are read by
the C++ at every call, as in the reference.  The threaded paths merge
per-thread partials through the same fold, so every thread count gives
the single-thread result bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..buildlib import build_shared
from ..obs import trace as _obs

LIB_NAME = "libsheep_torch_native.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _openmp_flag() -> list:
    """``["-fopenmp"]`` when g++ accepts it (the reference Makefile's
    probe), else ``[]``: the library then builds serial and reports
    threads=1."""
    try:
        ok = subprocess.run(
            ["g++", "-fopenmp", "-x", "c++", "-E", os.devnull],
            capture_output=True).returncode == 0
    except OSError:
        return []
    return ["-fopenmp"] if ok else []


def _command(src: str, out: str) -> list:
    return ["g++", "-O3", "-std=c++17", "-fPIC", *_openmp_flag(),
            "-Wall", "-Wextra", "-shared", "-o", out, src]


def load_library() -> ctypes.CDLL:
    """The native library, compiled from the checkout's source if needed;
    raises RuntimeError when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared("sheep_native.cpp", LIB_NAME,
                                           _command))
            _bind(lib)
            _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """Declare the C ABI."""
    lib.sheep_build_forest.restype = ctypes.c_int
    lib.sheep_build_forest.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, _u32p, _u32p, ctypes.c_void_p]
    lib.sheep_edges_to_links.restype = ctypes.c_int64
    lib.sheep_edges_to_links.argtypes = [
        _u32p, _u32p, ctypes.c_int64, _u32p, ctypes.c_int64, _u32p, _u32p]
    lib.sheep_build_forest_edges.restype = ctypes.c_int
    lib.sheep_build_forest_edges.argtypes = [
        _u32p, _u32p, ctypes.c_int64, _u32p, ctypes.c_int64,
        ctypes.c_int64, _u32p, _u32p, ctypes.c_void_p]
    lib.sheep_build_forest_links_begin.restype = ctypes.c_int
    lib.sheep_build_forest_links_begin.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, _u32p, _u32p, _u32p]
    lib.sheep_build_forest_links_block.restype = ctypes.c_int64
    lib.sheep_build_forest_links_block.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, _u32p, _u32p, _u32p]
    lib.sheep_build_forest_links_finish.restype = ctypes.c_int
    lib.sheep_build_forest_links_finish.argtypes = [
        ctypes.c_int64, _u32p, _u32p]
    lib.sheep_forward_partition.restype = ctypes.c_int64
    lib.sheep_forward_partition.argtypes = [
        _u32p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p]
    lib.sheep_degree_histogram.restype = ctypes.c_int
    lib.sheep_degree_histogram.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.sheep_degree_histogram_acc.restype = ctypes.c_int
    lib.sheep_degree_histogram_acc.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.sheep_degree_sequence.restype = ctypes.c_int64
    lib.sheep_degree_sequence.argtypes = [_i64p, ctypes.c_int64, _u32p]
    lib.sheep_degree_sequence_edges.restype = ctypes.c_int64
    lib.sheep_degree_sequence_edges.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, _u32p]
    lib.sheep_jxn_build.restype = ctypes.c_int64
    lib.sheep_jxn_build.argtypes = [
        _u32p, _u32p, ctypes.c_int64, _u32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _u32p, _u32p, _u32p, _i64p]
    lib.sheep_fennel_vertex.restype = ctypes.c_int
    lib.sheep_fennel_vertex.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int, _i64p]
    lib.sheep_fennel_edges.restype = ctypes.c_int
    lib.sheep_fennel_edges.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, _i64p]
    lib.sheep_insert_links.restype = ctypes.c_int64
    lib.sheep_insert_links.argtypes = [
        _u32p, _u32p, ctypes.c_int64, _u32p, _u32p, ctypes.c_int64]
    lib.sheep_subtree_aggregates.restype = ctypes.c_int
    lib.sheep_subtree_aggregates.argtypes = [
        _u32p, ctypes.c_int64, _i64p, _i64p]
    lib.sheep_eval_block.restype = ctypes.c_int64
    lib.sheep_eval_block.argtypes = [
        _u32p, _u32p, ctypes.c_int64, _i64p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        _u64p, _u64p, ctypes.c_void_p, ctypes.c_void_p,
        _u8p, _i64p, _i64p, _i64p, ctypes.c_int64]
    for name in ("sheep_native_omp", "sheep_native_threads",
                 "sheep_omp_max_threads"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.sheep_threads_for.restype = ctypes.c_int
    lib.sheep_threads_for.argtypes = [ctypes.c_int64]
    lib.sheep_last_thread_stats.restype = ctypes.c_int
    lib.sheep_last_thread_stats.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]


def available() -> bool:
    """True once the library is built and loaded; a failed build raises
    instead of answering False (the port has no numpy fallback)."""
    return load_library() is not None


# -- threading --------------------------------------------------------------
# The LIBRARY is the authority on what runs: a build without OpenMP
# reports threads=1 whatever the environment says.


def omp_compiled() -> bool:
    """True when the library was compiled with OpenMP."""
    return bool(load_library().sheep_native_omp())


def resolve_threads() -> int:
    """The resolved ``SHEEP_NATIVE_THREADS``: what an ungated kernel call
    would use (1 without OpenMP; clamped to the granted cores unless
    ``SHEEP_NATIVE_OVERSUB=1``)."""
    return int(load_library().sheep_native_threads())


def threads_for(m: int) -> int:
    """Threads a kernel call over ``m`` records or links will use, after
    the engagement floor and the per-slice work gate."""
    return int(load_library().sheep_threads_for(m))


def omp_max_threads() -> int:
    """``omp_get_max_threads()`` of the loaded OpenMP runtime (1 without
    OpenMP)."""
    return int(load_library().sheep_omp_max_threads())


def last_thread_stats() -> tuple[int, list[float]]:
    """(threads used, per-thread busy seconds) of the last kernel call
    made on THIS Python thread (the C++ keeps the stats thread-local on
    the calling thread)."""
    buf = (ctypes.c_double * 64)()
    used = int(load_library().sheep_last_thread_stats(buf, 64))
    return used, [buf[i] for i in range(min(used, 64))]


def _threads_live() -> bool:
    """Cheap pre-gate: skip the per-call stats read when no thread count
    is configured (the default path)."""
    return os.environ.get("SHEEP_NATIVE_THREADS", "") not in ("", "0", "1")


def _annotate_threads(sp) -> None:
    """Merge the last kernel call's thread use into its span: ``threads``
    (what the kernel really used; the gates may have picked 1) and, when
    threaded, the per-thread busy seconds."""
    used, busy = last_thread_stats()
    if used > 1:
        sp.annotate(threads=used,
                    thread_busy_s=[round(b, 6) for b in busy])
    else:
        sp.annotate(threads=1)


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def _pst_arg(pst, n: int):
    """(array kept alive, pointer) of an optional pst [n] input."""
    if pst is None:
        return None, None
    pst = _u32(pst)
    if pst.shape != (n,):
        raise ValueError(f"pst must have shape ({n},), got {pst.shape}")
    return pst, pst.ctypes.data_as(ctypes.c_void_p)


def build_forest_links(lo: np.ndarray, hi: np.ndarray, n: int,
                       pst: np.ndarray | None = None,
                       compute_pre: bool = False):
    """Exact forest fold; returns (parent, pst) uint32 [n], plus the
    reference's pre_weight array (lib/jnode.h:174-176) when
    ``compute_pre``.  Links with hi >= n count toward pst (when ``pst``
    is None) but never link; lo >= n raises (rc -3)."""
    lib = load_library()
    lo, hi = _u32(lo), _u32(hi)
    if lo.shape != hi.shape:
        raise ValueError(f"lo/hi shapes differ: {lo.shape} vs {hi.shape}")
    parent = np.empty(n, dtype=np.uint32)
    pst_out = np.empty(n, dtype=np.uint32)
    pst, pst_ptr = _pst_arg(pst, n)
    pre_out = np.empty(n, dtype=np.uint32) if compute_pre else None
    pre_ptr = pre_out.ctypes.data_as(ctypes.c_void_p) if compute_pre else None
    with _obs.span("native.build_forest", links=len(lo), n=n) as sp:
        rc = lib.sheep_build_forest(lo, hi, len(lo), n, pst_ptr, parent,
                                    pst_out, pre_ptr)
        if _threads_live():
            _annotate_threads(sp)
    if rc != 0:
        raise RuntimeError(f"sheep_build_forest failed rc={rc}")
    if compute_pre:
        return parent, pst_out, pre_out
    return parent, pst_out


class LinksFold:
    """Resumable fold (sheep_build_forest_links_begin/_block/_finish): the
    exact forest build consumed one ascending-hi window at a time, so the
    streamed handoff folds window k while window k+1 is still in flight.

    Windows must ascend by hi (an equal-hi group may split across adjacent
    windows); :meth:`block` raises ValueError on an out-of-order window, so
    a mis-sliced stream fails instead of building a different forest.
    ``pst`` None accumulates pst from the folded records, exact only when
    the windows together carry the ORIGINAL link multiset; reduced links
    need the prep-time pst here.
    """

    def __init__(self, n: int, pst: np.ndarray | None = None):
        self._lib = load_library()
        self.n = n
        self.accumulate_pst = pst is None
        self.parent = np.empty(n, dtype=np.uint32)
        self.pst = np.empty(n, dtype=np.uint32)
        self._uf = np.empty(n, dtype=np.uint32)
        self._bound = 0
        self._done = False
        pst, pst_ptr = _pst_arg(pst, n)
        rc = self._lib.sheep_build_forest_links_begin(
            n, pst_ptr, self.parent, self.pst, self._uf)
        if rc != 0:
            raise RuntimeError(f"sheep_build_forest_links_begin rc={rc}")

    def block(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Fold one window of links: every lo < n, and every linked hi
        (< n) at least every previous window's linked hi."""
        if self._done:
            raise RuntimeError("fold already finished")
        lo, hi = _u32(lo), _u32(hi)
        if lo.shape != hi.shape:
            raise ValueError(f"lo/hi shapes differ: {lo.shape} vs {hi.shape}")
        with _obs.span("native.links_fold.block", links=len(lo)) as sp:
            r = self._lib.sheep_build_forest_links_block(
                lo, hi, len(lo), self.n, self._bound,
                1 if self.accumulate_pst else 0, self.parent, self.pst,
                self._uf)
            if _threads_live():
                _annotate_threads(sp)
        if r == -7:
            raise ValueError(
                "out-of-order fold window: a linked hi precedes the "
                "previous window's range; windows must ascend by hi")
        if r == -3:
            raise ValueError(f"malformed link: lo >= n ({self.n})")
        if r < 0:
            raise RuntimeError(f"sheep_build_forest_links_block rc={r}")
        self._bound = int(r)

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        """Seal the fold; returns (parent, pst) uint32 [n]."""
        with _obs.span("native.links_fold.finish", n=self.n):
            rc = self._lib.sheep_build_forest_links_finish(
                self.n, self.parent, self._uf)
        if rc != 0:
            raise RuntimeError(f"sheep_build_forest_links_finish rc={rc}")
        self._done = True
        return self.parent, self.pst


def blocked_enabled() -> bool:
    """The cache-blocked kernel gate (SHEEP_NATIVE_BLOCKED, default on),
    read per call; the C++ reads the same variable for its own dispatch."""
    return os.environ.get("SHEEP_NATIVE_BLOCKED", "1") != "0"


def build_forest_edges(tail: np.ndarray, head: np.ndarray, pos: np.ndarray,
                       n: int, compute_pre: bool = False):
    """Fused edge -> forest build: records map through the position table
    straight into the cache-blocked union-find, with no intermediate link
    arrays.  Returns (parent, pst) uint32 [n] (+ pre when
    ``compute_pre``), bit-identical to edges_to_links +
    build_forest_links."""
    lib = load_library()
    tail, head, pos = _u32(tail), _u32(head), _u32(pos)
    parent = np.empty(n, dtype=np.uint32)
    pst_out = np.empty(n, dtype=np.uint32)
    pre_out = np.empty(n, dtype=np.uint32) if compute_pre else None
    pre_ptr = pre_out.ctypes.data_as(ctypes.c_void_p) if compute_pre else None
    with _obs.span("native.build_forest_edges", records=len(tail),
                   n=n) as sp:
        rc = lib.sheep_build_forest_edges(tail, head, len(tail), pos,
                                          len(pos), n, parent, pst_out,
                                          pre_ptr)
        if _threads_live():
            _annotate_threads(sp)
    if rc != 0:
        raise RuntimeError(f"sheep_build_forest_edges failed rc={rc}")
    if compute_pre:
        return parent, pst_out, pre_out
    return parent, pst_out


def edges_to_links(tail: np.ndarray, head: np.ndarray, pos: np.ndarray):
    """Map edge records through a position table; drops self-loops and
    both-absent records, keeps one-absent records as pst-only links (hi
    INVALID).  Returns (lo, hi) uint32 arrays."""
    lib = load_library()
    tail, head, pos = _u32(tail), _u32(head), _u32(pos)
    lo = np.empty(len(tail), dtype=np.uint32)
    hi = np.empty(len(tail), dtype=np.uint32)
    k = lib.sheep_edges_to_links(tail, head, len(tail), pos, len(pos), lo, hi)
    return lo[:k], hi[:k]


def forward_partition(parent: np.ndarray, weights: np.ndarray,
                      max_component: int) -> np.ndarray:
    """Native first-fit-decreasing tree partition; returns int32 parts."""
    lib = load_library()
    parent = _u32(parent)
    weights = np.ascontiguousarray(weights, dtype=np.int64)
    parts = np.empty(len(parent), dtype=np.int32)
    with _obs.span("native.forward_partition", n=len(parent)):
        rc = lib.sheep_forward_partition(parent, weights, len(parent),
                                         max_component, parts)
    if rc == -2:
        raise ValueError(
            f"max_component {max_component} smaller than the heaviest node; "
            f"request fewer partitions or a larger balance factor")
    if rc == -3:
        raise ValueError(
            "corrupt tree: a parent entry is neither INVALID nor a valid "
            "node id (malformed .tre input?)")
    if rc < 0:
        raise RuntimeError(f"sheep_forward_partition failed rc={rc}")
    return parts


def _histogram_rc(rc: int, n: int, what: str) -> None:
    if rc == -3:
        raise ValueError(
            f"corrupt edge records: a vid is out of range for n={n}")
    if rc != 0:
        raise RuntimeError(f"{what} failed rc={rc}")


def degree_histogram(tail: np.ndarray, head: np.ndarray, n: int) -> np.ndarray:
    """Undirected-doubled degrees, int64 [n]; a vid >= n raises."""
    lib = load_library()
    tail, head = _u32(tail), _u32(head)
    deg = np.empty(n, dtype=np.int64)
    rc = lib.sheep_degree_histogram(tail, head, len(tail), n, deg)
    _histogram_rc(rc, n, "sheep_degree_histogram")
    return deg


def degree_histogram_acc(tail: np.ndarray, head: np.ndarray,
                         deg: np.ndarray) -> None:
    """Add one edge block's degree contributions INTO ``deg`` (int64 [n],
    caller-owned, not zeroed here): per-block adds equal the one-shot
    histogram over the concatenated records."""
    lib = load_library()
    tail, head = _u32(tail), _u32(head)
    if deg.dtype != np.int64 or not deg.flags["C_CONTIGUOUS"]:
        raise TypeError("deg must be a C-contiguous int64 array")
    with _obs.span("native.degree_histogram_acc", records=len(tail)) as sp:
        rc = lib.sheep_degree_histogram_acc(tail, head, len(tail),
                                            len(deg), deg)
        if _threads_live():
            _annotate_threads(sp)
    _histogram_rc(rc, len(deg), "sheep_degree_histogram_acc")


def insert_links(parent: np.ndarray, skip: np.ndarray, lo: np.ndarray,
                 hi: np.ndarray) -> int:
    """Fold the links ``lo[i] -> hi[i]`` (lo < hi), in order, into the
    live ``parent`` array through the ancestor memo ``skip``, both
    uint32 [n] and updated in place (the serve store's ``insert_link``
    loop, in one native call).  Returns the parent pointers rewritten; an
    index past the end raises IndexError."""
    for name, a in (("parent", parent), ("skip", skip)):
        if a.dtype != np.uint32 or not a.flags["C_CONTIGUOUS"] \
                or not a.flags["WRITEABLE"]:
            raise TypeError(f"{name} must be a writeable C-contiguous "
                            f"uint32 array (it is updated in place)")
    if len(skip) != len(parent) or len(lo) != len(hi):
        raise ValueError("insert_links: mismatched lengths")
    lib = load_library()
    rc = lib.sheep_insert_links(parent, skip, len(parent), _u32(lo),
                                _u32(hi), len(lo))
    if rc < 0:
        raise IndexError("insert_links: an index is past the end of the "
                         "forest")
    return int(rc)


def subtree_aggregates(parent: np.ndarray, pst: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(size, wsum) per node, int64: the node's subtree size and pst
    total (the serve store's ``_subtree_aggregates_at`` pass, in one
    native loop).  A parent past the end raises IndexError, as the
    python pass does."""
    lib = load_library()
    parent = _u32(parent)
    n = len(parent)
    size = np.empty(n, dtype=np.int64)
    wsum = np.array(pst, dtype=np.int64)
    if len(wsum) != n:
        raise ValueError("parent and pst differ in length")
    if lib.sheep_subtree_aggregates(parent, n, size, wsum) != 0:
        raise IndexError("a parent is past the end of the forest")
    return size, wsum


def jxn_build(tail: np.ndarray, head: np.ndarray, seq: np.ndarray,
              n_vid: int, width_limit: int, memory_limit: int,
              make_pad: bool, make_pst: bool, make_jxn: bool,
              find_max_width: bool, do_rooting: bool):
    """Native parameterized jxn insert (sheep_jxn_build).

    Returns (parent, pst, out_seq, widths) trimmed to the effective node
    count.  Raises MemoryError past memory_limit (rc -4) like the oracle,
    and ValueError on any other failure (rc < 0: a vid out of range)."""
    lib = load_library()
    tail, head, seq = _u32(tail), _u32(head), _u32(seq)
    cap = len(seq)
    parent = np.empty(cap, dtype=np.uint32)
    pst = np.empty(cap, dtype=np.uint32)
    out_seq = np.empty(cap, dtype=np.uint32)
    widths = np.empty(cap, dtype=np.int64)
    flags = (1 * make_pad) | (4 * make_pst) | (8 * make_jxn) | \
        (16 * find_max_width) | (32 * do_rooting)
    with _obs.span("native.jxn_build", records=len(tail), n=cap):
        n_out = lib.sheep_jxn_build(tail, head, len(tail), seq, cap, n_vid,
                                    width_limit, memory_limit, flags,
                                    parent, pst, out_seq, widths)
    if n_out == -4:
        raise MemoryError(
            f"pst/jxn tables exceed memory_limit={memory_limit}")
    if n_out < 0:
        raise ValueError(f"sheep_jxn_build failed rc={n_out}")
    k = int(n_out)
    return (parent[:k].copy(), pst[:k].copy(), out_seq[:k].copy(),
            widths[:k].copy())


def fennel_vertex(tail: np.ndarray, head: np.ndarray, n_vid: int,
                  num_parts: int, balance_factor: float,
                  edge_balanced: bool) -> np.ndarray:
    """Native greedy FENNEL vertex partition; int64 [n_vid], -1 invalid."""
    lib = load_library()
    tail, head = _u32(tail), _u32(head)
    parts = np.empty(n_vid, dtype=np.int64)
    rc = lib.sheep_fennel_vertex(tail, head, len(tail), n_vid, num_parts,
                                 balance_factor, int(edge_balanced), parts)
    if rc != 0:
        raise ValueError(f"sheep_fennel_vertex failed rc={rc}")
    return parts


def fennel_edges(tail: np.ndarray, head: np.ndarray, n_vid: int,
                 num_parts: int, balance_factor: float) -> np.ndarray:
    """Native streaming FENNEL edge partition; int64 [num_records]."""
    lib = load_library()
    tail, head = _u32(tail), _u32(head)
    eparts = np.empty(len(tail), dtype=np.int64)
    rc = lib.sheep_fennel_edges(tail, head, len(tail), n_vid, num_parts,
                                balance_factor, eparts)
    if rc != 0:
        raise ValueError(f"sheep_fennel_edges failed rc={rc}")
    return eparts


def degree_sequence_from_edges(tail: np.ndarray, head: np.ndarray,
                               n: int) -> np.ndarray | None:
    """Fused histogram + counting-sort degree sequence in one call.
    Returns None when the record count or the degree range outgrows the
    kernel's buckets (callers take the two-call path); a vid >= n
    raises."""
    lib = load_library()
    tail, head = _u32(tail), _u32(head)
    seq = np.empty(n, dtype=np.uint32)
    with _obs.span("native.degree_sequence_edges", records=len(tail)) as sp:
        k = lib.sheep_degree_sequence_edges(tail, head, len(tail), n, seq)
        if _threads_live():
            _annotate_threads(sp)
    if k == -3:
        raise ValueError(
            f"corrupt edge records: a vid is out of range for n={n}")
    if k < 0:
        return None
    return seq[:k].copy()


def degree_sequence_from_degrees(deg: np.ndarray) -> np.ndarray | None:
    """Counting-sort degree sequence (ascending degree, vid tie break).
    Returns None when the degree range is too wide for counting buckets
    (a multigraph hub can push max_degree far past n); callers then use
    the comparison sort."""
    deg = np.ascontiguousarray(deg, dtype=np.int64)
    if len(deg) and int(deg.max()) > max(4 * len(deg), 1 << 20):
        return None
    lib = load_library()
    seq = np.empty(len(deg), dtype=np.uint32)
    with _obs.span("native.degree_sequence", n=len(deg)) as sp:
        k = lib.sheep_degree_sequence(deg, len(deg), seq)
        if _threads_live():
            _annotate_threads(sp)
    return seq[:k].copy()


def eval_block(tail: np.ndarray, head: np.ndarray, parts: np.ndarray,
               pos: np.ndarray | None, w0: int, first_window: bool,
               m_vcom: np.ndarray, m_hash: np.ndarray,
               m_down: np.ndarray | None, m_up: np.ndarray | None,
               deg_mask: np.ndarray, hash_loads: np.ndarray,
               down_loads: np.ndarray, up_loads: np.ndarray,
               num_parts: int) -> int:
    """One block of the streamed partition evaluator: updates the window
    bitmaps and load counters in place (they are the caller's state
    buffers, mutated, not copied); returns the edges_cut increment."""
    lib = load_library()
    tail, head = _u32(tail), _u32(head)
    pos_ptr, pos_len, down_ptr, up_ptr = 0, 0, 0, 0
    if pos is not None:
        # the C kernel writes m_down/m_up whenever pos is given
        for name, a in (("pos", pos), ("m_down", m_down), ("m_up", m_up)):
            want = np.uint32 if name == "pos" else np.uint64
            if a is None or a.dtype != want or not a.flags["C_CONTIGUOUS"]:
                raise TypeError(f"{name} must be a C-contiguous "
                                f"{np.dtype(want).name} array with pos")
        pos_ptr, pos_len = pos.ctypes.data, len(pos)
        down_ptr, up_ptr = m_down.ctypes.data, m_up.ctypes.data
    rc = lib.sheep_eval_block(
        tail, head, len(tail), parts, len(parts), pos_ptr, pos_len,
        w0, 1 if first_window else 0, m_vcom, m_hash, down_ptr, up_ptr,
        deg_mask, hash_loads, down_loads, up_loads, num_parts)
    if rc < 0:
        raise ValueError(
            "sheep_eval_block: a vid is out of range of parts/pos, or a "
            "streamed vertex has an invalid part id (e.g. INVALID_PART "
            "-1); parts must cover every vid in the edge stream")
    return int(rc)
