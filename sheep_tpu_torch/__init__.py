"""sheep_tpu_torch: the PyTorch/CUDA port of sheep_tpu for NVIDIA Hopper.

The port mirrors ``sheep_tpu``'s module layout and function names so each
counterpart is easy to find, but imports nothing of it (and never
``jax``): what it needs from the host-only layers it keeps as its own copy.

Layout:
  core/       host oracle: Forest, build_forest (+ streaming, merge,
              pre weights), sequences, tree facts, the streamed
              handoff's window bounds and resumable fold, the fast
              forest validator (core/validate.py), the treewidth mode
              (core/jxn.py)
  native/     ctypes binding of the native host runtime
              (csrc/sheep_native.cpp): the union-find fold (plain,
              cache-blocked, OpenMP-threaded; monolithic, resumable,
              fused from edges), the fused degree sort, the forward
              tree partition, FENNEL, the evaluator's block, the
              treewidth insert
  io/         edge-list readers and writers (.dat XS1 binary, .net SNAP
              text), .tre and .seq files, the crash-safe writer with
              its fault hooks, the block prefetcher
  partition/  tree partitioners (forward FFD et al.), Partition and its
              writers, the evaluators (in memory and streamed), FENNEL
  ops/        device ops on torch tensors: sort, the reduce loop, the
              hybrid build with its streamed windowed handoff, K1's
              wrapper (ops/fused_jump.py, csrc/fused_jump.cu) and the
              backend probe's kernels P1 and P2 (ops/probe.py,
              csrc/probe_kernels.cu); and the external-memory build
              (ops/extmem.py) and its supervised distributed form
              (ops/distext.py), which are host code and load no torch
  runtime/    the fault-tolerant build: retry, watchdog, checkpoint and
              resume, the degradation ladder (build_graph_resilient,
              mesh -> single -> host -> stream -> ext -> spill)
  integrity/, resources/, plan/, obs/
              the host layers the runtime stands on: sidecar checksums,
              budgets and retention, the rung and distext planner, the
              trace and the metrics registry
  cli/        the command-line tools (python -m sheep_tpu_torch.cli.<tool>:
              graph2tree, degree_sequence, make_graph, partition_tree,
              merge_trees, fsck, plan, supervise, distext, trace, serve,
              worker, route, top), and
              cli/tools.py, the six analysis tools the util/ shims start
              (tree2dot, tree2adj, graph2adj, vfennel, efennel,
              read_partition)
  parallel/   the -i/-r build over a mesh of workers: the Mesh with its
              collectives over torch.distributed (NCCL on CUDA, gloo on
              the CPU), the sharded, chunked and streaming mesh builds
  serve/      the serve tier: the group-committed WAL, ServeCore
              (bootstrap, recovery, inserts, queries, snapshots), the
              crash-safe re-sequence job, admission, the wire grammar
              and client, the fault plans; the daemon with WAL
              replication, epoch-fenced failover, anti-entropy scrub
              and tenants; the remote build workers; the routed fleet
              (the consistent-hash router, live tenant migration, the
              rebalancer)
  supervisor/ the chaos-hardened tournament supervisor: heartbeat,
              durable manifest, SHEEP_FAULT_PLAN chaos, the orchestrator
              whose runners start the port's own tools or ship distext
              legs to remote workers, --status
  scripts/    tools: the backend probe (python -m
              sheep_tpu_torch.scripts.kernel_probe)
  utils/      synthetic R-MAT graphs, the environment capture, the
              SHEEP_* knob registry
  convert     numpy state <-> tensors on a device

The host layers are copies of the reference's modules.  The port has
every module of the reference but ``utils/compat.py``, a jax
``shard_map`` shim whose job ``parallel.mesh.Mesh`` does.

Only the routes that reach the card load torch: the package, ``ops``
and ``runtime`` resolve their device modules lazily, so the serial,
external-memory and treewidth builds and the tools run in a process
that never imports it (a memory budget prices the process's RSS).

Entry points (``ops.build.build_graph_hybrid``, ``build_graph_device``,
``runtime.build_graph_resilient``, ``parallel.build_graph_distributed``,
``cli.graph2tree.main`` on its -i/-r and checkpoint routes, the probe
tool) run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

INVALID_JNID = 0xFFFFFFFF
INVALID_VID = 0xFFFFFFFF
INVALID_PART = -1


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``None`` means
    ``"cuda"``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and CUDA is absent — the CPU is used only when the caller
    names it.  torch loads here, not at package import: the host routes
    (the serial and external-memory builds, the tools) never load it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: sheep_tpu_torch entry points run on "
            "the GPU by default; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
