"""Worker liveness (port of sheep_tpu/supervisor, its heartbeat only).

  heartbeat.py  heartbeat files + deadlines: a CLI launched with
                ``SHEEP_HEARTBEAT_FILE`` beats it from a daemon thread
                (cli.common.maybe_start_heartbeat)

The tournament supervisor itself (manifest, chaos plans, the
orchestrator) is not ported yet; ROADMAP.md §1 keeps its place in the
queue.
"""

from .heartbeat import (HEARTBEAT_FILE_ENV, HeartbeatWriter, beat, is_stale,
                        last_beat_s, maybe_start_from_env)

__all__ = ["HEARTBEAT_FILE_ENV", "HeartbeatWriter", "beat", "is_stale",
           "last_beat_s", "maybe_start_from_env"]
