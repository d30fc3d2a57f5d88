"""Chaos-hardened tournament supervisor for the distributed file path
(port of sheep_tpu/supervisor).

Six modules, layered bottom-up:

  heartbeat.py  worker liveness: heartbeat files + deadlines (mtime-based,
                so shell and Python workers implement one protocol); a
                CLI launched with ``SHEEP_HEARTBEAT_FILE`` beats it from a
                daemon thread (cli.common.maybe_start_heartbeat)
  manifest.py   the durable tournament manifest: planned bracket +
                per-leg state, atomic + checksummed — what makes a
                crashed run resumable
  chaos.py      deterministic fault injection (SHEEP_FAULT_PLAN grammar:
                kill/corrupt/hang a leg, stop the supervisor)
  supervise.py  the orchestrator: dispatch, fsck-gated publish,
                retry/backoff, deadline relaunch, speculative
                re-execution, fsck-driven resume, disk-budget GC and
                per-leg cores budgeting; its runners start the port's
                own tools (``python -m sheep_tpu_torch.cli.<tool>``)
  status.py     ``supervise --status``: the manifest + heartbeat +
                budget-headroom operator report (read-only)

  remote.py     the remote dispatch arm: RemoteRunner ships distext
                legs to worker daemons (``python -m
                sheep_tpu_torch.cli.worker``) over the fleet wire behind
                the same runner seam

Everything here is host code: no module loads torch.
"""

from .chaos import (ChaosFault, ChaosPlan, SupervisorKilled, parse_fault_plan,
                    plan_from_env)
from .heartbeat import (HEARTBEAT_FILE_ENV, HeartbeatWriter, beat, is_stale,
                        last_beat_s, maybe_start_from_env)
from .manifest import (Leg, Manifest, load_manifest, manifest_path,
                       plan_distext, plan_tournament, save_manifest,
                       tournament_rounds)
from .remote import RemoteRunner, wire_status_path
from .status import render_status, status_rows
from .supervise import (InlineRunner, SubprocessRunner, SupervisionFailed,
                        SupervisorConfig, TournamentSupervisor, reconcile,
                        run_supervised, sweep_attempt_debris)

__all__ = [
    "ChaosFault",
    "ChaosPlan",
    "HEARTBEAT_FILE_ENV",
    "HeartbeatWriter",
    "InlineRunner",
    "Leg",
    "Manifest",
    "RemoteRunner",
    "SubprocessRunner",
    "SupervisionFailed",
    "SupervisorConfig",
    "SupervisorKilled",
    "TournamentSupervisor",
    "beat",
    "is_stale",
    "last_beat_s",
    "load_manifest",
    "manifest_path",
    "maybe_start_from_env",
    "parse_fault_plan",
    "plan_from_env",
    "plan_distext",
    "plan_tournament",
    "reconcile",
    "render_status",
    "run_supervised",
    "save_manifest",
    "status_rows",
    "sweep_attempt_debris",
    "tournament_rounds",
    "wire_status_path",
]
