"""Flight recorder and metrics (port of sheep_tpu/obs, less its
``merge``): spans and events appended crash-safely to a JSONL file named
by ``SHEEP_TRACE`` (unset = disabled at ~zero cost), which the
fault-tolerant build records (ladder decisions, dispatches, checkpoints,
fault firings), the planner's prior store reads back and ``supervise
--status`` rolls up by phase; and the dependency-free metrics registry
with the process's own accounting (``proc_status``, which each distext
leg self-reports)."""

from .metrics import (Counter, Gauge, Histogram, Registry,
                      parse_prometheus, proc_status, relabel,
                      set_process_gauges)
from .trace import (close_recorder, enabled, event, read_trace, rollup,
                    span, timed, trace_segments)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "close_recorder",
           "enabled", "event", "parse_prometheus", "proc_status",
           "read_trace", "relabel", "rollup", "set_process_gauges", "span",
           "timed", "trace_segments"]
