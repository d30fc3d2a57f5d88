"""ctypes binding of the port's sequential union-find fold
(``csrc/host_fold.cpp``), built with g++ at first use into ``_build/``.

The port has no pure-python fold: a failed build raises.
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
