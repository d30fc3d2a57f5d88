"""Resource-exhaustion hardening: budgets, refusals, reclamation.

Three modules, layered bottom-up:

  errors.py    the ResourceError taxonomy (DiskExhausted / WriteFault /
               MemoryBudgetExceeded), all OSError subclasses so existing
               recovery paths already speak the language
  governor.py  SHEEP_MEM_BUDGET / SHEEP_DISK_BUDGET enforcement: measured
               RSS + statvfs + analytic per-chunk allocation estimates ->
               typed refusals BEFORE the OOM killer or ENOSPC can strike
  gc.py        retention-policy reclamation for managed directories
               (keep-last-k + keep-resumable), orphan-temp sweeping

The deterministic I/O fault layer that drives all of this under test
lives with the writers it wraps (io/faultfs.py, SHEEP_IO_FAULT_PLAN).
"""

from .errors import (DiskExhausted, MemoryBudgetExceeded, ResourceError,
                     WriteFault)
from .gc import gc_orphan_temps, is_orphan_temp, retention_gc
from .governor import (DISK_BUDGET_ENV, MEM_BUDGET_ENV, ResourceGovernor,
                       dir_usage, disk_free, parse_size, rss_bytes,
                       snapshot_nbytes)

__all__ = [
    "DISK_BUDGET_ENV",
    "DiskExhausted",
    "MEM_BUDGET_ENV",
    "MemoryBudgetExceeded",
    "ResourceError",
    "ResourceGovernor",
    "WriteFault",
    "dir_usage",
    "disk_free",
    "gc_orphan_temps",
    "is_orphan_temp",
    "parse_size",
    "retention_gc",
    "rss_bytes",
    "snapshot_nbytes",
]
