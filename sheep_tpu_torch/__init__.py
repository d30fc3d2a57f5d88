"""sheep_tpu_torch: the PyTorch/CUDA port of sheep_tpu for NVIDIA Hopper.

The port mirrors ``sheep_tpu``'s module layout and function names so each
counterpart is easy to find, but imports nothing of it (and never
``jax``): what it needs from the host-only layers it keeps as its own copy.

Layout:
  core/       host oracle: Forest, build_forest (+ streaming, merge,
              pre weights), sequences, tree facts, the streamed
              handoff's window bounds and resumable fold, the fast
              forest validator (core/validate.py)
  native/     ctypes binding of the native host runtime
              (csrc/sheep_native.cpp): the union-find fold (plain,
              cache-blocked, OpenMP-threaded; monolithic, resumable,
              fused from edges), the fused degree sort, the forward
              tree partition, FENNEL, the evaluator's block
  io/         edge-list readers and writers (.dat XS1 binary, .net SNAP
              text), .tre and .seq files, the crash-safe writer with
              its fault hooks, the block prefetcher
  partition/  tree partitioners (forward FFD et al.), Partition and its
              writers, the evaluators (in memory and streamed), FENNEL
  ops/        device ops on torch tensors: sort, the reduce loop, the
              hybrid build with its streamed windowed handoff, K1's
              wrapper (ops/fused_jump.py, csrc/fused_jump.cu) and the
              backend probe's kernels P1 and P2 (ops/probe.py,
              csrc/probe_kernels.cu)
  runtime/    the fault-tolerant build: retry, watchdog, checkpoint and
              resume, the degradation ladder (build_graph_resilient)
  integrity/, resources/, plan/, obs/
              the host layers the runtime stands on: sidecar checksums,
              budgets and retention, the rung planner, the trace
  cli/        the command-line tools (python -m sheep_tpu_torch.cli.<tool>:
              graph2tree, degree_sequence, make_graph, partition_tree,
              merge_trees, fsck)
  parallel/   the -i/-r build at world size 1 (the hybrid on the card)
  supervisor/ the worker heartbeat
  scripts/    tools: the backend probe (python -m
              sheep_tpu_torch.scripts.kernel_probe)
  utils/      synthetic R-MAT graphs, the environment capture, the
              SHEEP_* knob registry
  convert     numpy state <-> tensors on a device

The host layers are copies of the reference's modules; their notes still
name reference modules the port has not ported yet (serve/, most of
supervisor/, ops/extmem.py, ops/distext.py, core/jxn.py), whose queue is
in ROADMAP.md §1 (``QUEUE`` below names each item).

Entry points (``ops.build.build_graph_hybrid``, ``build_graph_device``,
``runtime.build_graph_resilient``, ``parallel.build_graph_distributed``,
``cli.graph2tree.main`` on its -i/-r and checkpoint routes, the probe
tool) run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

INVALID_JNID = 0xFFFFFFFF
INVALID_VID = 0xFFFFFFFF
INVALID_PART = -1

#: reference modules not ported yet, by their ROADMAP.md §1 queue item;
#: a route that needs one fails with a message naming its item
QUEUE = {
    "extmem": "item 1 (ops/extmem.py)",
    "jxn": "item 2 (core/jxn.py)",
    "parallel": "item 3 (parallel/ over torch.distributed)",
    "distext": "item 4 (ops/distext.py)",
    "serve": "item 6 (serve/)",
    "supervisor": "item 7 (supervisor/)",
}


def unported(*keys: str) -> str:
    """The tail of the message a route that needs the ``QUEUE`` items
    ``keys`` raises."""
    return (f"is not ported to sheep_tpu_torch yet: it waits for "
            f"ROADMAP.md §1 {' and '.join(QUEUE[k] for k in keys)}")


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
