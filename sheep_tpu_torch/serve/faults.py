"""Deterministic service-level fault injection for the serve daemon.

The offline fault plans cover writes (``SHEEP_IO_FAULT_PLAN``) and
tournament legs (``SHEEP_FAULT_PLAN``); a long-lived server adds failure
shapes neither can name — the PROCESS dying between "the insert is
durable" and "the client heard OK", a handler hanging past its deadline, a
slow client squatting on a slot.  ``SHEEP_SERVE_FAULT_PLAN`` makes each
one fire on cue, at a named request boundary, so every recovery path the
daemon claims (WAL replay, typed timeout refusals, admission shedding) is
rehearsed deterministically — the same discipline as PRs 1-5.  Grammar::

    SHEEP_SERVE_FAULT_PLAN = entry[,entry...]
    entry                  = kind @ site : nth
    kind                   = kill | hang | slow
    site                   = req | query | insert | wal | apply | *
    nth                    = 0-based index of that site's firing

The sites are the boundaries of one request's lifecycle:

  req     any request, counted at dispatch (before the handler runs)
  query   a read request (part/ecv/subtree/...), at dispatch
  insert  an insert request, at dispatch — BEFORE its WAL append, so a
          kill here loses an unacknowledged insert (allowed: it was never
          acknowledged)
  wal     immediately after the insert's WAL record is fsync'd (under
          group commit: after the SHARED group fsync that covers it),
          before the OK is written — the critical boundary: a kill here
          MUST recover the insert from the log
          (kill-at-every-insert-boundary property, tests/test_serve.py)
  apply   after the in-memory apply is durable, before the OK is
          written — a kill here must change nothing on replay (the
          record is already applied; replay must be idempotent by seqno)

The leader group-commit path adds the two boundaries that
exist BEFORE the shared fsync — both may lose the record, and both are
allowed to, because the OK is only written after the fsync:

  gc-append    inside the critical section, before the deferred
               (sync=False) WAL append — a kill here loses the insert
               entirely; it was never appended, applied, or acked
  gc-unsynced  after the deferred append + in-memory apply, before the
               shared group fsync — the record is in the OS file but
               not durable; a power cut here tears the group tail and
               replay stops at the last synced boundary (never acked,
               so nothing acked is lost)

The re-sequence job (serve/reseq.py) adds its four phase
boundaries — each one a point where kill -9 must resume or abort
cleanly off the durable reseq manifest (mid-FOLD kills are the extmem
checkpoint boundaries: ``SHEEP_FAULT_PLAN``'s ``ext-boundary`` site):

  reseq-hist  before the histogram/counting-sort sequence rebuild
              (manifest just durable at phase "hist")
  reseq-fold  before the streamed fold over .dat + WAL'd inserts
              (manifest at phase "fold", new sig pinned)
  reseq-swap  before the in-memory swap (pending tree artifact + phase
              "swap" durable; a kill here must redo the swap from the
              pending artifact, bit-identically)
  reseq-seal  after the swap, before the sealing snapshot — the
              in-memory state is new, the disk is old: a kill here
              restarts on the OLD generation and resumes the rebuild

The anti-entropy machinery (serve/scrub.py +
replicate._heal_quarantine) adds its phase boundaries — the quarantine
marker is durable BEFORE each fires, so a kill at any of them restarts
into the same phase, reads stay refused throughout, and divergent data
is never served:

  quar-enter   right after the durable quarantine marker lands on a
               VERIFY mismatch (phase "diverged")
  quar-resync  after the marker advances to phase "resync", before the
               leader snapshot fetch — a kill re-fetches idempotently
  quar-verify  after the adopted state is in place and the marker
               records the rejoin crc (phase "verify"), before the
               durable clear — a kill re-runs the (idempotent) re-sync
  quar-clear   after the marker is cleared and reads are re-admitted
  scrub-quar   right after the artifact scrubber renames a failed
               artifact to ``*.quarantined`` (before its repair)
  scrub-repair after a successful repair publishes, before the scrub
               manifest records it

Kinds:

  kill    the daemon dies instantly (``os._exit(137)`` — no atexit, no
          flushing: kill -9).  In-process harnesses install a plan with
          ``kill_mode="raise"`` and catch :class:`ServeKilled` instead,
          exactly like the supervisor's SupervisorKilled.
  hang    the handler stalls (sleeps past the request deadline, bounded
          by ``hang_cap_s``): the deadline/timeout refusal shape.
  slow    the handler stalls briefly while HOLDING its admission slot:
          the slow-client shape that drives shedding under load.

Counters are per-site and reset per plan install (same discipline as
io/faultfs.py) so "hurt insert 3" names the same request on every run.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

SERVE_FAULT_PLAN_ENV = "SHEEP_SERVE_FAULT_PLAN"

KINDS = ("kill", "hang", "slow")
SITES = ("req", "query", "insert", "gc-append", "gc-unsynced", "wal",
         "apply", "reseq-hist", "reseq-fold", "reseq-swap", "reseq-seal",
         "quar-enter", "quar-resync", "quar-verify", "quar-clear",
         "scrub-quar", "scrub-repair",
         "*")

#: how long a "slow" fault stalls while holding its slot
SLOW_S = 0.25


class ServeKilled(RuntimeError):
    """Simulated daemon death (kill_mode="raise").  Never caught inside
    the serve stack: harnesses catch it at top level and re-open the
    state dir, exactly like a restarted process."""


@dataclass
class ServeFault:
    kind: str
    site: str
    nth: int

    def matches(self, site: str, index: int) -> bool:
        return (self.site == "*" or self.site == site) and index == self.nth


@dataclass
class ServeFaultPlan:
    """Parsed plan; entries pop as they fire (recovery requests run
    clean).  ``kill_mode``: "exit" (daemon: os._exit(137)) or "raise"
    (in-process harnesses: ServeKilled)."""

    faults: list[ServeFault] = field(default_factory=list)
    kill_mode: str = "exit"

    def take(self, site: str, index: int) -> str | None:
        for i, f in enumerate(self.faults):
            if f.matches(site, index):
                del self.faults[i]
                return f.kind
        return None


def parse_serve_fault_plan(spec: str,
                           kill_mode: str = "exit") -> ServeFaultPlan:
    faults = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            kind, at = entry.split("@", 1)
            site, nth = at.split(":", 1)
        except ValueError:
            raise ValueError(
                f"{SERVE_FAULT_PLAN_ENV} entry {entry!r}: want "
                f"kind@site:nth (e.g. kill@wal:3)")
        kind = kind.strip()
        site = site.strip()
        if kind not in KINDS:
            raise ValueError(
                f"{SERVE_FAULT_PLAN_ENV} entry {entry!r}: kind {kind!r} "
                f"must be one of {'/'.join(KINDS)}")
        if site not in SITES:
            raise ValueError(
                f"{SERVE_FAULT_PLAN_ENV} entry {entry!r}: site {site!r} "
                f"must be one of {'/'.join(SITES)}")
        faults.append(ServeFault(kind=kind, site=site, nth=int(nth)))
    return ServeFaultPlan(faults=faults, kill_mode=kill_mode)


_plan: ServeFaultPlan | None = None
_env_spec: str | None = None
_counters: dict[str, int] = {}


def install_plan(plan: ServeFaultPlan | None) -> None:
    """Install (or with None, clear) the active plan and reset counters."""
    global _plan, _env_spec
    _plan = plan
    _env_spec = None
    _counters.clear()


def clear_plan() -> None:
    install_plan(None)


def _active_plan() -> ServeFaultPlan | None:
    """The installed plan, else the env plan — parsed once per spec so
    fired entries and counters survive across requests (io/faultfs.py
    discipline)."""
    global _plan, _env_spec
    if _plan is not None:
        return _plan
    spec = os.environ.get(SERVE_FAULT_PLAN_ENV, "")
    if not spec:
        return None
    if spec != _env_spec:
        _plan = parse_serve_fault_plan(spec)
        _env_spec = spec
        return _plan
    return None


def arm(site: str) -> str | None:
    """Count one firing of ``site`` and return the fault kind armed for
    it (None = healthy)."""
    index = _counters.get(site, 0)
    _counters[site] = index + 1
    plan = _active_plan()
    if plan is None:
        return None
    return plan.take(site, index)


def fire(site: str, hang_s: float = 0.0) -> str | None:
    """Arm ``site`` and execute the armed fault in place:

      kill  never returns (os._exit or ServeKilled per kill_mode)
      hang  sleeps ``hang_s`` (the caller passes its deadline remainder)
      slow  sleeps SLOW_S

    Returns the kind that fired (None = healthy) so callers can account
    for it (the daemon's stats count injected faults honestly)."""
    kind = arm(site)
    if kind is None:
        return None
    from ..obs import trace as obs
    obs.event("serve.fault", site=site, kind=kind)
    if kind == "kill":
        plan = _active_plan()
        if plan is not None and plan.kill_mode == "raise":
            raise ServeKilled(f"injected kill at serve site {site!r} "
                              f"({SERVE_FAULT_PLAN_ENV})")
        os._exit(137)  # kill -9: no cleanup, no flushing, no goodbye
    if kind == "hang":
        time.sleep(max(0.0, hang_s))
    elif kind == "slow":
        time.sleep(SLOW_S)
    return kind
