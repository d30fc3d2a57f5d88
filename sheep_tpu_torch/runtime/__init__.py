"""Fault-tolerant chunked-build runtime (port of sheep_tpu/runtime).

Four modules, layered bottom-up:

  faults.py    deterministic fault injection + the exception taxonomy,
               with the classifier of torch's CUDA errors and the rule
               of which failures may degrade
  snapshot.py  resumable checkpoint format (atomic .npz at chunk bounds)
  retry.py     retry-with-backoff + adaptive round-count shrinking, and
               the watchdog that syncs a dispatch on a CUDA event
  config.py    the build's knobs, ``RuntimeConfig``
  driver.py    checkpointed build driver + the mesh -> single -> host
               -> stream -> ext -> spill graceful-degradation ladder,
               ``build_graph_resilient(..., device=None)``

See driver.py's docstring for the failure model and the determinism
argument (why a resumed or degraded build is bit-identical).

Only driver.py loads torch, and its names resolve lazily (PEP 562): the
external-memory build imports ``runtime.faults``, ``runtime.retry`` and
``runtime.snapshot`` in a process that must never load it.
"""

from .config import RuntimeConfig
from .faults import (BuildKilled, DeadlineExceeded, DeviceHung, FaultPlan,
                     InjectedDispatchFault, RetryBudgetExhausted, clear_plan,
                     degradable, fault_point, install_plan, is_retryable,
                     reset_counters)
from .retry import RetryPolicy, run_with_retry
from .snapshot import Checkpointer, Snapshot, input_signature, load_snapshot

__all__ = [
    "BuildKilled",
    "Checkpointer",
    "ChunkRuntime",
    "DeadlineExceeded",
    "DeviceHung",
    "FaultPlan",
    "InjectedDispatchFault",
    "RetryBudgetExhausted",
    "RetryPolicy",
    "RuntimeConfig",
    "Snapshot",
    "build_graph_resilient",
    "clear_plan",
    "degradable",
    "fault_point",
    "input_signature",
    "install_plan",
    "is_retryable",
    "load_snapshot",
    "reset_counters",
    "run_with_retry",
]

_LAZY = {"ChunkRuntime": "driver", "build_graph_resilient": "driver"}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value  # cache: the next access skips the lookup
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
