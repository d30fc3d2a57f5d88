"""Kernel K1: the fused multi-level pointer-jump descent.

Port of sheep_tpu/ops/pallas_jump.py (``jump_group``, ``fused_descend``,
``fused_jump``).  The descent of every reduce round (``ops.forest.
_lift_descend``) lifts each live link's lo through L ancestor tables
T_k = f^(2^k), deepest first, keeping lo < hi.  On a CUDA tensor the
descent is the hand-written Hopper kernel in ``csrc/fused_jump.cu``
(built with nvcc at first use into ``_build/``, bound with ctypes); on a
CPU tensor it is the plain torch version.  There is no fallback between
the two: a CUDA input launches the kernel or raises.

On the card the descent runs in L2-sized table groups, as the reference
runs it in VMEM-sized ones (``pallas_jump.py:119-128``):
:func:`plan_groups` splits the L tables into groups that fit a share of
the card's L2 (read from the device, :func:`l2_cache_bytes`), and
:func:`descend_groups` launches K1 once per group, each launch reading
the previous one's output.

The table squarings T_{k+1} = T_k[T_k] stay torch indexing and the
``moved`` count stays a torch reduction, as they stay jnp outside the
Pallas call in the JAX package.

``launches`` counts kernel launches (incremented only where the kernel is
launched, once per table group), so a run can show that its main path went
through K1.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..buildlib import build_shared, nvcc_command

_LIB_NAME = "libfused_jump.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: kernel launches since the last reset (set it to 0 to reset)
launches = 0

#: The share of the L2 that one group's tables may fill.  Random gathers
#: slow down once their tables pass about half of the H100's 50 MB: one
#: launch per table at E = 2^26 took 0.51 ms a level with 8.4 or 16.8 MB
#: tables and 0.74 ms with a 33.5 MB one, and one pass over four 16.8 MB
#: tables 1.9 times as long as four launches (one H100, chip_smoke.py's
#: K1 phase).  Half gives one table a launch at n >= 2^22, six at 2^20.
L2_TABLE_SHARE = 1 / 2


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
            lib.sheep_l2_cache_bytes.restype = ctypes.c_int64
            lib.sheep_l2_cache_bytes.argtypes = []
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def l2_cache_bytes(device: torch.device) -> int:
    """The L2 size in bytes of a CUDA device (cudaDevAttrL2CacheSize)."""
    if device.type != "cuda":
        raise ValueError(f"l2_cache_bytes needs a CUDA device, got {device}")
    lib = load_library()
    with torch.cuda.device(device):
        got = lib.sheep_l2_cache_bytes()
    if got <= 0:
        raise RuntimeError(f"cannot read the L2 size of {device}: "
                           f"CUDA error {-got}")
    return got


def plan_groups(levels: int, width: int, l2_bytes: int,
                sorted_links: bool = False) -> list:
    """Table groups for one descent, deepest first: ``[(start, stop),
    ...]`` covering ``range(levels)`` in order, each of ``g = max(1,
    budget // (4 * width))`` tables (the last may hold fewer), where the
    budget is :data:`L2_TABLE_SHARE` of ``l2_bytes``.

    ``sorted_links``: the links come from ``sort_links`` (ordered by lo),
    so neighbouring links gather neighbouring entries and a pass sweeps
    each table in order, needing no more than a window of it in L2: then
    one group of all the tables, which saves the re-streaming of lo/hi
    per group (on the real build's first chunk round, n = 2^23,
    E = 2^26, L = 4, one H100: 0.98 ms in one pass against 1.43 ms in
    four launches, chip_smoke.py)."""
    if levels < 1 or width < 1 or l2_bytes < 1:
        raise ValueError(f"plan_groups: levels, width and l2_bytes must be "
                         f">= 1, got {levels}, {width}, {l2_bytes}")
    if sorted_links:
        return [(0, levels)]
    g = max(1, int(l2_bytes * L2_TABLE_SHARE) // (4 * width))
    return [(s, min(s + g, levels)) for s in range(0, levels, g)]


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
                    hi: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K1 once: descend lo through ``tables`` (int32 [L, n+1],
    deepest first) where the step stays below hi, into ``out`` (a new
    tensor if None).  CUDA tensors only."""
    global launches
    _check_args(tables, lo, hi)
    if lo.device.type != "cuda":
        raise ValueError(f"jump_group_cuda needs CUDA tensors, got "
                         f"{lo.device}")
    if out is None:
        out = torch.empty_like(lo)
    elif (out.dtype != torch.int32 or out.shape != lo.shape
          or not out.is_contiguous() or out.device != lo.device):
        raise ValueError("out must be a contiguous int32 tensor like lo")
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
    select per table, the gather index taken as K1 and jnp take it: a
    negative lo counts from the end, then it is clamped into the table."""
    for table in tables:
        width = table.numel()
        idx = torch.where(lo < 0, lo + width, lo).clamp(0, width - 1)
        nlo = torch.index_select(table, 0, idx)
        lo = torch.where(nlo < hi, nlo, lo)
    return lo


def jump_group(tables: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if lo.device.type == "cpu":
        _check_args(tables, lo, hi)
        return jump_group_plain(tables, lo, hi)
    return jump_group_cuda(tables, lo, hi)


def descend_groups(tables: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   groups: list) -> torch.Tensor:
    """The descent through ``tables`` one group at a time (``groups`` as
    :func:`plan_groups` gives them), each group reading the previous
    group's output.  On CUDA tensors one K1 launch per group, ping-ponging
    between two output buffers; on CPU tensors the plain version per
    group."""
    if lo.device.type == "cpu":
        _check_args(tables, lo, hi)
        for start, stop in groups:
            lo = jump_group_plain(tables[start:stop], lo, hi)
        return lo
    bufs = [torch.empty_like(lo)]
    if len(groups) > 1:
        bufs.append(torch.empty_like(lo))
    for i, (start, stop) in enumerate(groups):
        lo = jump_group_cuda(tables[start:stop], lo, hi, out=bufs[i % 2])
    return lo


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
                  f: torch.Tensor, sorted_links: bool = False):
    """Descent through a given one-step table f [n+1]: build the lifted
    tables, then descend through them, on the card in the groups that
    :func:`plan_groups` fits to its L2 (one K1 launch each;
    ``sorted_links`` as there), on the CPU in one plain pass.  Returns
    (lo, moved int32 0-d) like ops.forest._jump, moved counted against
    the input lo."""
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    tables = lift_tables(f.to(torch.int32), levels)
    depth, width = tables.shape
    groups = [(0, depth)] if lo.device.type == "cpu" else \
        plan_groups(depth, width, l2_cache_bytes(lo.device), sorted_links)
    out = descend_groups(tables, lo, hi, groups)
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
