"""Kernels P1 and P2: the backend probe's two kernels.

Port of the two Pallas kernels of scripts/pallas_probe.py: P1, ``add_one``
(``x + 1``, stage 1: does a trivial kernel run at all), and P2,
``jump_step`` (one level of the reduce round's pointer jump, ``nlo =
f[lo]; out = nlo < hi ? nlo : lo``, stage 2: the plain 1-D gather that
kernel K1 is built from, on its own).  Both are hand-written Hopper
kernels in ``csrc/probe_kernels.cu``, built with nvcc at first use into
``_build/`` and bound with ctypes.

``add_one`` and ``jump_step`` launch the kernel on CUDA tensors and raise
on any other; ``add_one_plain`` and ``jump_step_plain`` are the same
functions in plain torch; :func:`dispatch` runs the plain version on CPU
tensors only.  ``launches`` counts launches by kernel name, incremented
only where a kernel is launched.

P2 marks its gathers into f L2 evict_last and streams lo, hi and out
evict-first (the source note of ``csrc/probe_kernels.cu``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..buildlib import build_shared, nvcc_command

_LIB_NAME = "libprobe_kernels.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

#: kernel launches since the last reset, by kernel (set a value to 0 to
#: reset it)
launches = {"add_one": 0, "jump_step": 0}


def load_library() -> ctypes.CDLL:
    """The probe kernels' library, compiled from the checkout's source if
    needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_shared("probe_kernels.cu", _LIB_NAME, nvcc_command)
            lib = ctypes.CDLL(path)
            lib.sheep_probe_add_one.restype = ctypes.c_int
            lib.sheep_probe_add_one.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p]
            lib.sheep_probe_jump_step.restype = ctypes.c_int
            lib.sheep_probe_jump_step.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p]
            _lib = lib
    return _lib


def _check(name: str, **tensors: torch.Tensor) -> None:
    """int32, contiguous, and on one CUDA device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    for arg, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def add_one(x: torch.Tensor) -> torch.Tensor:
    """Launch P1: ``x + 1`` over an int32 CUDA tensor of any shape."""
    _check("add_one", x=x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(lib.sheep_probe_add_one(x.data_ptr(), out.data_ptr(),
                                          x.numel(), stream), "add_one")
    launches["add_one"] += 1
    return out


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """P1's function in plain torch."""
    return x + 1


def jump_step(f: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Launch P2: ``nlo = f[lo]; out = nlo < hi ? nlo : lo`` on int32
    CUDA tensors (f [width], lo/hi [E]), lo indexed as jnp indexes
    (:func:`jump_step_plain`)."""
    _check("jump_step", f=f, lo=lo, hi=hi)
    if f.dim() != 1 or f.numel() < 1:
        raise ValueError(f"jump_step: f must be 1-D and non-empty, got "
                         f"{tuple(f.shape)}")
    if lo.dim() != 1 or lo.shape != hi.shape:
        raise ValueError(f"jump_step: lo/hi must be 1-D of one length, got "
                         f"{tuple(lo.shape)} and {tuple(hi.shape)}")
    out = torch.empty_like(lo)
    if lo.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        _raise_on(lib.sheep_probe_jump_step(
            f.data_ptr(), f.numel(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), lo.numel(), stream), "jump_step")
    launches["jump_step"] += 1
    return out


def jump_step_plain(f: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """P2's function in plain torch, the gather index taken as jnp takes
    it: a negative lo counts from the end, then it is clamped into f."""
    width = f.numel()
    idx = torch.where(lo < 0, lo + width, lo).clamp(0, width - 1)
    nlo = torch.index_select(f, 0, idx)
    return torch.where(nlo < hi, nlo, lo)


def dispatch(kernel, plain, *tensors: torch.Tensor) -> torch.Tensor:
    """``plain(*tensors)`` when every tensor lies on the CPU, else
    ``kernel(*tensors)``, which launches or raises.  No fallback between
    the two."""
    if all(t.device.type == "cpu" for t in tensors):
        return plain(*tensors)
    return kernel(*tensors)
