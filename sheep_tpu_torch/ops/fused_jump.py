"""Kernel K1: the fused multi-level pointer-jump descent.

Port of sheep_tpu/ops/pallas_jump.py (``jump_group``, ``fused_descend``,
``fused_jump``).  The descent of every reduce round (``ops.forest.
_lift_descend``) lifts each live link's lo through L ancestor tables
T_k = f^(2^k), deepest first, keeping lo < hi.  On a CUDA tensor the
descent is the hand-written Hopper kernel in ``csrc/fused_jump.cu``
(built with nvcc at first use into ``_build/``, bound with ctypes); on a
CPU tensor it is the plain torch version.  There is no fallback between
the two: a CUDA input launches the kernel or raises.

The table squarings T_{k+1} = T_k[T_k] stay torch indexing and the
``moved`` count stays a torch reduction, as they stay jnp outside the
Pallas call in the JAX package.

``launches`` counts kernel launches (incremented only where the kernel is
launched), so a run can show that its main path went through K1.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..buildlib import build_shared, nvcc_command

_LIB_NAME = "libfused_jump.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0


def load_library() -> ctypes.CDLL:
    """K1's library, compiled from the checkout's source if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_shared("fused_jump.cu", _LIB_NAME, nvcc_command)
            lib = ctypes.CDLL(path)
            lib.sheep_fused_jump.restype = ctypes.c_int
            lib.sheep_fused_jump.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
    return _lib


def _check_args(tables: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> None:
    for name, t in (("tables", tables), ("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tables.dim() != 2 or tables.shape[0] < 1 or tables.shape[1] < 1:
        raise ValueError(f"tables must be [levels >= 1, n+1], got "
                         f"{tuple(tables.shape)}")
    if lo.dim() != 1 or lo.shape != hi.shape:
        raise ValueError(f"lo/hi must be 1-D of one length, got "
                         f"{tuple(lo.shape)} and {tuple(hi.shape)}")
    if not (tables.device == lo.device == hi.device):
        raise ValueError(f"tensors on different devices: {tables.device}, "
                         f"{lo.device}, {hi.device}")


def jump_group_cuda(tables: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """Launch K1: descend lo through ``tables`` (int32 [L, n+1], deepest
    first) where the step stays below hi.  CUDA tensors only."""
    global launches
    _check_args(tables, lo, hi)
    if lo.device.type != "cuda":
        raise ValueError(f"jump_group_cuda needs CUDA tensors, got "
                         f"{lo.device}")
    out = torch.empty_like(lo)
    e = lo.numel()
    if e == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(lo.device).cuda_stream
    with torch.cuda.device(lo.device):
        rc = lib.sheep_fused_jump(
            tables.data_ptr(), tables.shape[0], tables.shape[1],
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(), e, stream)
    if rc != 0:
        raise RuntimeError(f"fused_jump kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def jump_group_plain(tables: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """K1's function in plain torch: the same descent, one gather and one
    select per table."""
    for table in tables:
        nlo = torch.index_select(table, 0, lo)
        lo = torch.where(nlo < hi, nlo, lo)
    return lo


def jump_group(tables: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if lo.device.type == "cpu":
        _check_args(tables, lo, hi)
        return jump_group_plain(tables, lo, hi)
    return jump_group_cuda(tables, lo, hi)


def lift_tables(f: torch.Tensor, levels: int) -> torch.Tensor:
    """Ancestor tables f^(2^k), k < levels, as one int32 [levels, n+1]
    tensor, deepest stride first (at least one level, as in the
    reference, whose loop always keeps f)."""
    levels = max(1, levels)
    tables = torch.empty((levels, f.shape[0]), dtype=torch.int32,
                         device=f.device)
    tables[levels - 1] = f
    for k in range(levels - 2, -1, -1):
        torch.index_select(tables[k + 1], 0, tables[k + 1], out=tables[k])
    return tables


def fused_descend(lo: torch.Tensor, hi: torch.Tensor, n: int, levels: int,
                  f: torch.Tensor):
    """Descent through a given one-step table f [n+1]: build the lifted
    tables, then one K1 pass.  Returns (lo, moved int32 0-d) like
    ops.forest._jump."""
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    out = jump_group(lift_tables(f.to(torch.int32), levels), lo, hi)
    return out, (out != lo).sum(dtype=torch.int32)


def fused_descend_plain(lo: torch.Tensor, hi: torch.Tensor, n: int,
                        levels: int, f: torch.Tensor):
    """The same function in plain torch: the reference's _lift_descend
    loop (square f into tables, then descend deepest first)."""
    lo_in = lo
    tables = [f]
    for _ in range(levels - 1):
        tables.append(torch.index_select(tables[-1], 0, tables[-1]))
    for table in reversed(tables):
        nlo = torch.index_select(table, 0, lo)
        lo = torch.where(nlo < hi, nlo, lo)
    return lo, (lo != lo_in).sum(dtype=torch.int32)


def fused_jump(lo: torch.Tensor, hi: torch.Tensor, n: int, levels: int):
    """Self-contained fused jump: builds its own one-step table (the
    min up-neighbour of each vertex over the links, slot n for
    sentinels), then :func:`fused_descend`."""
    from .forest import min_up_table

    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    return fused_descend(lo, hi, n, levels, min_up_table(lo, hi, n))
