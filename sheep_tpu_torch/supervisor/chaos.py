"""Deterministic fault injection for the tournament supervisor (port of
sheep_tpu/supervisor/chaos.py: the same grammar, the same firing order).

``SHEEP_FAULT_PLAN`` names exactly which legs of the tournament get hurt
and how — the orchestration-layer sibling of the chunk runtime's
``SHEEP_FAULT_INJECT`` (runtime/faults.py).  Grammar::

    SHEEP_FAULT_PLAN = entry[,entry...]
    entry            = kind @ round : leg
    kind             = kill | corrupt | hang | stop
    round            = integer (0 = map, 1.. = merge rounds) | "sort"
    leg              = slot index within the round

e.g. ``SHEEP_FAULT_PLAN=kill@0:2,corrupt@1:0,hang@2:0``.  Each entry fires
exactly ONCE, on the first dispatch of the named leg, so the supervisor's
recovery (re-dispatch, relaunch, speculation) then runs against a healthy
worker — which is what lets the kill/corrupt/hang-at-every-round property
test assert bit-identical output (tests/test_supervisor.py).

The kinds model the four distinct failure shapes the supervisor must
survive, each driving a DIFFERENT recovery path:

  kill     the worker dies mid-write: a torn, sidecar-less partial lands
           at the attempt's temp name and the attempt reports failure.
           Recovery: retry-with-backoff re-dispatch.
  corrupt  the worker "succeeds" but its artifact is damaged after the
           write (bit rot, torn copy): bytes flipped under an unchanged
           sidecar.  Recovery: the supervisor's publish-time fsck rejects
           the artifact and re-dispatches the leg.
  hang     the worker freezes: one heartbeat at launch, then silence,
           never completing.  Recovery: the heartbeat deadline declares it
           dead and a fresh attempt is dispatched.
  stop     the SUPERVISOR dies right after this leg publishes (raises
           :class:`SupervisorKilled`, caught by nobody).  Recovery: a new
           supervisor resumes off the manifest, fscks the surviving
           artifacts, and re-dispatches only the dirty/missing legs.

Faults are applied at the supervisor's dispatch boundary, not inside the
worker, so the same plan is byte-for-byte deterministic under every
runner (inline threads and real subprocesses alike).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

FAULT_PLAN_ENV = "SHEEP_FAULT_PLAN"

KINDS = ("kill", "corrupt", "hang", "stop")

#: the round number the grammar word "sort" maps to (manifest.Leg.round)
SORT_ROUND = -1


class SupervisorKilled(RuntimeError):
    """Simulated supervisor death (kind="stop").  Never caught inside the
    supervisor: tests and the chaos smoke catch it at top level and start
    a NEW supervisor over the same state dir, exactly like a restarted
    process."""


@dataclass
class ChaosFault:
    kind: str
    round: int
    leg: int


@dataclass
class ChaosPlan:
    """A parsed fault plan; entries are popped as they fire."""

    faults: list[ChaosFault] = field(default_factory=list)

    def _take(self, kinds: tuple[str, ...], round: int,
              leg: int) -> str | None:
        for i, f in enumerate(self.faults):
            if f.kind in kinds and f.round == round and f.leg == leg:
                del self.faults[i]
                return f.kind
        return None

    def take_dispatch(self, round: int, leg: int) -> str | None:
        """The kill/corrupt/hang fault (if any) armed for this leg's next
        dispatch; popped so recovery dispatches run clean."""
        return self._take(("kill", "corrupt", "hang"), round, leg)

    def take_stop(self, round: int, leg: int) -> bool:
        """True when the supervisor is scheduled to die after this leg
        publishes."""
        return self._take(("stop",), round, leg) is not None


def parse_fault_plan(spec: str) -> ChaosPlan:
    """Parse the ``SHEEP_FAULT_PLAN`` grammar (module docstring)."""
    faults = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            kind, at = entry.split("@", 1)
            rnd_s, leg_s = at.split(":", 1)
        except ValueError:
            raise ValueError(
                f"SHEEP_FAULT_PLAN entry {entry!r}: want kind@round:leg "
                f"(e.g. kill@0:2)")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"SHEEP_FAULT_PLAN entry {entry!r}: kind {kind!r} must be "
                f"one of {'/'.join(KINDS)}")
        rnd_s = rnd_s.strip()
        rnd = SORT_ROUND if rnd_s == "sort" else int(rnd_s)
        faults.append(ChaosFault(kind=kind, round=rnd, leg=int(leg_s)))
    return ChaosPlan(faults=faults)


def plan_from_env() -> ChaosPlan | None:
    """The env-configured plan, or None when chaos is off (the default)."""
    spec = os.environ.get(FAULT_PLAN_ENV, "")
    if not spec:
        return None
    return parse_fault_plan(spec)
