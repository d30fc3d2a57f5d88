"""Flight recorder and metrics (port of sheep_tpu/obs): spans and events
appended crash-safely to a JSONL file named by ``SHEEP_TRACE`` (unset =
disabled at ~zero cost), stamped with the request id of the thread's
``rid_scope`` and sampled per span name under ``SHEEP_TRACE_SAMPLE``,
which the fault-tolerant build, the serve store and its WAL record;
the dependency-free metrics registry with the process's own accounting
(``proc_status``, which each distext leg self-reports); and
``obs.merge``, which stitches many processes' traces by rid for
``python -m sheep_tpu_torch.cli.trace --merge``.  ``capture`` keeps the
spans in memory instead, for a benchmark's traced run."""

from .metrics import (Counter, Gauge, Histogram, Registry,
                      parse_prometheus, proc_status, relabel,
                      set_process_gauges)
from .trace import (capture, close_recorder, current_rid, enabled, event,
                    new_rid, overlap_stats, read_trace, read_trace_chain,
                    repair_trace, rid_scope, rollup, span, timed,
                    trace_segments, trace_summary)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "capture", "close_recorder",
    "parse_prometheus", "proc_status", "relabel", "set_process_gauges",
    "current_rid", "enabled", "event", "new_rid", "overlap_stats",
    "read_trace", "read_trace_chain", "repair_trace", "rid_scope",
    "rollup", "span", "timed", "trace_segments", "trace_summary",
]
