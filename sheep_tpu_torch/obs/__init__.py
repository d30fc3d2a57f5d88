"""Flight recorder (port of sheep_tpu/obs, its trace half): spans and
events appended crash-safely to a JSONL file named by ``SHEEP_TRACE``
(unset = disabled at ~zero cost), which the fault-tolerant build records
(ladder decisions, dispatches, checkpoints, fault firings) and the
planner's prior store reads back."""

from .trace import (close_recorder, enabled, event, read_trace, span,
                    timed, trace_segments)

__all__ = ["close_recorder", "enabled", "event", "read_trace", "span",
           "timed", "trace_segments"]
