"""Fault-tolerant chunked-build runtime (port of sheep_tpu/runtime).

Four modules, layered bottom-up:

  faults.py    deterministic fault injection + the exception taxonomy,
               with the classifier of torch's CUDA errors and the rule
               of which failures may degrade
  snapshot.py  resumable checkpoint format (atomic .npz at chunk bounds)
  retry.py     retry-with-backoff + adaptive round-count shrinking, and
               the watchdog that syncs a dispatch on a CUDA event
  driver.py    checkpointed build driver + the single -> host -> stream
               -> spill graceful-degradation ladder,
               ``build_graph_resilient(..., device=None)``

See driver.py's docstring for the failure model and the determinism
argument (why a resumed or degraded build is bit-identical).
"""

from .driver import (ChunkRuntime, RuntimeConfig, build_graph_resilient)
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
