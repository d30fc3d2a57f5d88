"""ctypes binding of the port's sequential union-find fold
(``csrc/host_fold.cpp``), built with g++ at first use into ``_build/``:
the monolithic :func:`build_forest_links` and the resumable
:class:`LinksFold` of the streamed handoff share one fold.

The port has no pure-python fold: a failed build raises.  ctypes releases
the GIL for each call, so a fold overlaps the handoff's fetch thread.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..buildlib import build_shared

_LIB_NAME = "libsheep_host_fold.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def load_library() -> ctypes.CDLL:
    """The fold library, compiled from the checkout's source if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_shared(
                "host_fold.cpp", _LIB_NAME,
                lambda src, out: ["g++", "-O3", "-std=c++17", "-shared",
                                  "-fPIC", "-o", out, src])
            lib = ctypes.CDLL(path)
            lib.sheep_build_forest.restype = ctypes.c_int
            lib.sheep_build_forest.argtypes = [
                _u32p, _u32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, _u32p, _u32p]
            lib.sheep_build_forest_links_begin.restype = ctypes.c_int
            lib.sheep_build_forest_links_begin.argtypes = [
                ctypes.c_int64, ctypes.c_void_p, _u32p, _u32p, _u32p]
            lib.sheep_build_forest_links_block.restype = ctypes.c_int64
            lib.sheep_build_forest_links_block.argtypes = [
                _u32p, _u32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, _u32p, _u32p, _u32p]
            lib.sheep_build_forest_links_finish.restype = ctypes.c_int
            lib.sheep_build_forest_links_finish.argtypes = [
                ctypes.c_int64, _u32p, _u32p]
            _lib = lib
    return _lib


def build_forest_links(lo: np.ndarray, hi: np.ndarray, n: int,
                       pst: np.ndarray | None = None):
    """Exact forest fold; returns (parent, pst) uint32 [n].  Links with
    hi >= n count toward pst (when ``pst`` is None) but never link."""
    lib = load_library()
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    if lo.shape != hi.shape:
        raise ValueError(f"lo/hi shapes differ: {lo.shape} vs {hi.shape}")
    parent = np.empty(n, dtype=np.uint32)
    pst_out = np.empty(n, dtype=np.uint32)
    pst_ptr = None
    if pst is not None:
        pst = np.ascontiguousarray(pst, dtype=np.uint32)
        if pst.shape != (n,):
            raise ValueError(f"pst must have shape ({n},), got {pst.shape}")
        pst_ptr = pst.ctypes.data_as(ctypes.c_void_p)
    rc = lib.sheep_build_forest(lo, hi, len(lo), n, pst_ptr, parent, pst_out)
    if rc != 0:
        raise RuntimeError(f"sheep_build_forest failed rc={rc}")
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
        pst_ptr = None
        if pst is not None:
            pst = np.ascontiguousarray(pst, dtype=np.uint32)
            if pst.shape != (n,):
                raise ValueError(
                    f"pst must have shape ({n},), got {pst.shape}")
            pst_ptr = pst.ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.sheep_build_forest_links_begin(
            n, pst_ptr, self.parent, self.pst, self._uf)
        if rc != 0:
            raise RuntimeError(f"sheep_build_forest_links_begin rc={rc}")

    def block(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Fold one window of links: every lo < n, and every linked hi
        (< n) at least every previous window's linked hi."""
        if self._done:
            raise RuntimeError("fold already finished")
        lo = np.ascontiguousarray(lo, dtype=np.uint32)
        hi = np.ascontiguousarray(hi, dtype=np.uint32)
        if lo.shape != hi.shape:
            raise ValueError(f"lo/hi shapes differ: {lo.shape} vs {hi.shape}")
        r = self._lib.sheep_build_forest_links_block(
            lo, hi, len(lo), self.n, self._bound,
            1 if self.accumulate_pst else 0, self.parent, self.pst, self._uf)
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
        rc = self._lib.sheep_build_forest_links_finish(
            self.n, self.parent, self._uf)
        if rc != 0:
            raise RuntimeError(f"sheep_build_forest_links_finish rc={rc}")
        self._done = True
        return self.parent, self.pst
