"""Deterministic NETWORK fault injection for the replicated serve
cluster.

The service-level plan (serve/faults.py) hurts one node's request
lifecycle; replication adds failure shapes that live BETWEEN nodes — a
frame lost on the wire, a link partitioned mid-stream, a slow segment, a
duplicate delivery.  ``SHEEP_SERVE_NETFAULT_PLAN`` makes each one fire on
cue at a named frame boundary of the leader's send path, so every
follower recovery claim (gap-triggered re-sync, idempotent dup drop,
heartbeat-deadline failover, reconnect-and-resume) is rehearsed
deterministically — the same discipline as ``SHEEP_IO_FAULT_PLAN`` and
``SHEEP_SERVE_FAULT_PLAN``.  Grammar::

    SHEEP_SERVE_NETFAULT_PLAN = entry[,entry...]
    entry                     = kind @ site : nth
    kind                      = drop | partition | slow | dup
    site                      = repl | hb | wleg | wbeat | wart
                              | msnap | mdelta | mcut | *
    nth                       = 0-based index of that site's firing

Sites are outbound frame classes — the replication leader's, plus the
build-worker wire's (serve/worker.py):

  repl   one REPL APPEND frame (a replicated WAL record) about to be
         sent to one follower
  hb     one REPL PING frame (the replication-stream heartbeat that
         carries the leader's latest seqno)
  wleg   one LEG dispatch (the supervisor shipping a distext leg's
         slice to a remote build worker); drop = the job never arrives
         (staleness redispatches), partition = the link dies before
         dispatch, dup = duplicate delivery to a second worker —
         first-finisher-wins arbitration must discard the loser
  wbeat  one worker->supervisor BEAT frame (the wire heartbeat);
         partition here kills the link mid-leg
  wart   the worker's artifact return; partition here tears the
         transfer mid-payload — the crc gate must refuse it and the
         supervisor redispatch exactly one leg
  msnap  one migration snapshot fetch (serve/migrate.py
         phase 1: the target leader pulling the tenant's crc-verified
         snapshot from the source); drop/partition = the fetch dies and
         the phase retries from scratch (sidecar-first landing means a
         torn fetch admits nothing), dup = the bootstrap runs twice —
         idempotent by the tmp+rename landing
  mdelta one migration delta frame (phase 2: a REPL APPEND sent to the
         migration-attached follower on the target); the recovery
         paths are the repl site's — gap-NACK re-stream, idempotent dup
         drop, reconnect-and-resume — exercised on the migration stream
         specifically
  mcut   one cutover RPC (phase 3: the router's MIG SEAL/CUT/remap
         legs); every cutover verb is idempotent, so drop/partition =
         the driver retries or aborts cleanly back to the source, dup =
         the verb lands twice and the second is a no-op
  reseq  one replicated re-sequence announce (the REPL RESEQ
         frame broadcasting the swap); drop = the follower trips the
         ``gen=`` stamp on the next APPEND instead and snapshot-adopts
         then, partition = reconnect re-HELLOs into the sig-mismatch
         snapshot answer, dup = the second frame finds the follower
         already on the announced generation and ACKs idempotently —
         every arm converges on whole-generation adoption, never a
         half-swapped tree

Kinds model the distinct network failure shapes, each driving a
DIFFERENT follower recovery path:

  drop       the frame vanishes (never sent).  The follower sees the
             seqno gap on the NEXT frame (append or ping) and answers
             ``REPL NACK`` — the leader re-streams from the follower's
             applied seqno; an insert waiting on the follower's ack
             rides through as latency, not loss.
  partition  the link dies: the connection to that follower is closed
             from the nth frame on.  The follower reconnects with a
             fresh HELLO and resumes (or, if the leader's WAL moved
             past it, snapshot-bootstraps); a partition that outlives
             the failover deadline triggers leader election instead.
  slow       the frame is delayed (the congested-link shape feeding the
             bounded-staleness accounting).
  dup        the frame is delivered twice; the follower must drop the
             second idempotently by seqno.

Counters are per-site and reset per plan install (io/faultfs.py
discipline), so "drop replication frame 3" names the same frame on every
run.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

NETFAULT_PLAN_ENV = "SHEEP_SERVE_NETFAULT_PLAN"

KINDS = ("drop", "partition", "slow", "dup")
SITES = ("repl", "hb", "wleg", "wbeat", "wart",
         "msnap", "mdelta", "mcut", "reseq", "*")

#: how long a "slow" network fault delays one frame
SLOW_S = 0.05


@dataclass
class NetFault:
    kind: str
    site: str
    nth: int

    def matches(self, site: str, index: int) -> bool:
        return (self.site == "*" or self.site == site) and index == self.nth


@dataclass
class NetFaultPlan:
    """Parsed plan; entries pop as they fire (recovery frames run
    clean)."""

    faults: list[NetFault] = field(default_factory=list)

    def take(self, site: str, index: int) -> str | None:
        for i, f in enumerate(self.faults):
            if f.matches(site, index):
                del self.faults[i]
                return f.kind
        return None


def parse_netfault_plan(spec: str) -> NetFaultPlan:
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
                f"{NETFAULT_PLAN_ENV} entry {entry!r}: want kind@site:nth "
                f"(e.g. drop@repl:3)")
        kind = kind.strip()
        site = site.strip()
        if kind not in KINDS:
            raise ValueError(
                f"{NETFAULT_PLAN_ENV} entry {entry!r}: kind {kind!r} must "
                f"be one of {'/'.join(KINDS)}")
        if site not in SITES:
            raise ValueError(
                f"{NETFAULT_PLAN_ENV} entry {entry!r}: site {site!r} must "
                f"be one of {'/'.join(SITES)}")
        faults.append(NetFault(kind=kind, site=site, nth=int(nth)))
    return NetFaultPlan(faults=faults)


_plan: NetFaultPlan | None = None
_env_spec: str | None = None
_counters: dict[str, int] = {}


def install_plan(plan: NetFaultPlan | None) -> None:
    """Install (or with None, clear) the active plan and reset
    counters."""
    global _plan, _env_spec
    _plan = plan
    _env_spec = None
    _counters.clear()


def clear_plan() -> None:
    install_plan(None)


def _active_plan() -> NetFaultPlan | None:
    global _plan, _env_spec
    if _plan is not None:
        return _plan
    spec = os.environ.get(NETFAULT_PLAN_ENV, "")
    if not spec:
        return None
    if spec != _env_spec:
        _plan = parse_netfault_plan(spec)
        _env_spec = spec
        return _plan
    return None


def arm(site: str) -> str | None:
    """Count one firing of ``site`` and return the fault kind armed for
    it (None = healthy).  The caller executes the fault — dropping,
    duplicating, delaying, or closing is a SEND-path decision the
    injection layer cannot make generically."""
    index = _counters.get(site, 0)
    _counters[site] = index + 1
    plan = _active_plan()
    if plan is None:
        return None
    return plan.take(site, index)
