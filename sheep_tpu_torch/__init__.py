"""sheep_tpu_torch: the PyTorch/CUDA port of sheep_tpu for NVIDIA Hopper.

The port mirrors ``sheep_tpu``'s module layout and function names so each
counterpart is easy to find, but imports nothing of it (and never
``jax``): what it needs from the host-only layers it keeps as its own copy.

Layout:
  core/     host oracle: Forest, build_forest, sequences, tree facts,
            the streamed handoff's window bounds and resumable fold
  native/   ctypes binding of the sequential union-find fold, monolithic
            and resumable (csrc/host_fold.cpp)
  io/       edge-list readers (.dat XS1 binary, .net SNAP text)
  ops/      device ops on torch tensors: sort, the reduce loop, the hybrid
            build with its streamed windowed handoff, K1's wrapper
            (ops/fused_jump.py, csrc/fused_jump.cu) and the backend
            probe's kernels P1 and P2 (ops/probe.py, csrc/probe_kernels.cu)
  scripts/  tools: the backend probe (python -m
            sheep_tpu_torch.scripts.kernel_probe)
  utils/    synthetic R-MAT graphs
  convert   numpy state <-> tensors on a device

Entry points (``ops.build.build_graph_hybrid``, ``build_graph_device``,
the probe tool) run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

INVALID_JNID = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and CUDA is absent — the CPU is used only when the caller
    names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: sheep_tpu_torch entry points run on "
            "the GPU by default; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
