"""The router-side rebalancer: a fleet that moves its own tenants.

Live migration (serve/migrate.py) gives the fleet a verb; this module
gives it a POLICY.  A thread in the router process folds the
fleet scrape — per-tenant request counters, window p99, replication
lag, process RSS — into per-cluster load, prices the busiest tenant's
move with the plan layer's cost model (plan/model.plan_migration), and
drives ``Router.start_migration`` when the numbers say GO.

Deliberately conservative, because a rebalancer that flaps is worse
than none:

  off by default   ``SHEEP_REBALANCE=1`` opts in (cli/route.py starts
                   the thread; nothing else changes)
  hysteresis       the hottest cluster must out-qps the coolest by
                   ``SHEEP_REBALANCE_HYSTERESIS``x before a move is
                   even considered — inside the band, hold
  min traffic      below ``SHEEP_REBALANCE_MIN_QPS`` on the hot
                   cluster the fleet is quiet; moving tenants around
                   an idle fleet is churn
  one at a time    a migration in flight holds every verdict (the
                   driver is one-per-tenant; the POLICY is one total)
  cooldown         ``SHEEP_REBALANCE_COOLDOWN_S`` after a migration
                   lands before the next is considered, so the post-
                   move qps picture settles before it is judged

:func:`decide` is pure — two folded scrapes in, a verdict dict out —
so the hysteresis/cooldown behavior unit-tests without a socket.
Every verdict (hold or migrate, with its reason) is kept on a bounded
ring the router's METRICS and ``sheep top`` surface.
"""

from __future__ import annotations

import os
import threading
import time

#: master switch: the rebalancer thread only starts when this is "1"
REBALANCE_ENV = "SHEEP_REBALANCE"
#: seconds between fleet-scrape verdicts
INTERVAL_ENV = "SHEEP_REBALANCE_INTERVAL_S"
DEFAULT_INTERVAL_S = 5.0
#: quiet period after a migration lands before the next is considered
COOLDOWN_ENV = "SHEEP_REBALANCE_COOLDOWN_S"
DEFAULT_COOLDOWN_S = 30.0
#: hot cluster must out-qps the cool one by this factor to act
HYSTERESIS_ENV = "SHEEP_REBALANCE_HYSTERESIS"
DEFAULT_HYSTERESIS = 1.5
#: below this hot-cluster qps the fleet is considered quiet
MIN_QPS_ENV = "SHEEP_REBALANCE_MIN_QPS"
DEFAULT_MIN_QPS = 5.0

#: verdicts kept for METRICS / `sheep top`
VERDICT_RING = 32


def enabled() -> bool:
    return os.environ.get(REBALANCE_ENV, "") == "1"


def _knob_float(env: str, default: float) -> float:
    try:
        return float(os.environ.get(env, "") or default)
    except ValueError:
        return default


def fold_fleet(samples) -> dict:
    """Fold ``parse_prometheus`` triples from one fleet scrape into the
    rebalancer's working set:

    ``{"tenants": {name: {"requests": cum, "applied": seqno,
    "p99": s, "mig": bool}}, "clusters": {cid: {"rss": bytes,
    "lag": records}}}``

    Requests are CUMULATIVE counters summed across instances; qps
    comes from the delta between two folds (:func:`qps_of`).  A tenant
    mid-migration is flagged so every verdict holds while it moves.
    """
    tenants: dict[str, dict] = {}
    clusters: dict[str, dict] = {}

    def trec(name):
        return tenants.setdefault(name, {"requests": 0.0, "applied": 0,
                                         "p99": 0.0, "mig": False})

    for name, labels, val in samples:
        cid = labels.get("cluster")
        if cid and cid != "router":
            crec = clusters.setdefault(cid, {"rss": 0.0, "lag": 0.0})
            if name == "sheep_process_rss_bytes":
                crec["rss"] += val
            elif name == "sheep_fleet_repl_lag_max_records":
                # emitted by the router with a cluster LABEL, not the
                # member relabel — folded below
                pass
            elif name == "sheep_serve_repl_lag_records" and not (
                    set(labels) - {"cluster", "instance"}):
                crec["lag"] = max(crec["lag"], val)
        if name == "sheep_fleet_repl_lag_max_records":
            lcid = labels.get("cluster")
            if lcid:
                clusters.setdefault(
                    lcid, {"rss": 0.0, "lag": 0.0})["lag"] = max(
                    clusters[lcid]["lag"], val)
        tn = labels.get("tenant")
        if not tn:
            continue
        if name == "sheep_serve_tenant_requests_total":
            trec(tn)["requests"] += val
        elif name == "sheep_serve_tenant_applied_seqno":
            rec = trec(tn)
            rec["applied"] = max(rec["applied"], int(val))
        elif name == "sheep_serve_tenant_window_p99_seconds":
            rec = trec(tn)
            rec["p99"] = max(rec["p99"], val)
        elif name in ("sheep_serve_mig_phase",
                      "sheep_migrate_delta_lag_records") and val >= 1:
            trec(tn)["mig"] = True
    return {"tenants": tenants, "clusters": clusters}


def qps_of(prev: dict, cur: dict, dt_s: float) -> dict[str, float]:
    """Per-tenant qps from two folds' cumulative request counters.
    Counter resets (a restarted member) clamp to 0 instead of going
    negative."""
    if dt_s <= 0:
        return {}
    out = {}
    pt = prev.get("tenants", {})
    for tn, rec in cur.get("tenants", {}).items():
        d = rec["requests"] - pt.get(tn, {}).get("requests", 0.0)
        out[tn] = max(0.0, d) / dt_s
    return out


def decide(prev: dict, cur: dict, dt_s: float, placements: dict,
           *, hysteresis: float, min_qps: float,
           migration_inflight: bool = False,
           cooldown_remaining_s: float = 0.0,
           horizon_s: float = 60.0) -> dict:
    """One pure rebalance verdict.  ``placements`` maps tenant ->
    cluster id (the router's view, overrides included).  Returns
    ``{"action": "hold"|"migrate", "reason": ..., and for migrate:
    "tenant", "src", "dest", "plan": <plan_migration dict>}``."""
    from ..plan.model import plan_migration

    def hold(reason):
        return {"action": "hold", "reason": reason}

    if migration_inflight:
        return hold("a migration is already in flight "
                    "(one at a time)")
    if cooldown_remaining_s > 0:
        return hold(f"cooling down {cooldown_remaining_s:.0f}s after "
                    f"the last migration")
    qps = qps_of(prev, cur, dt_s)
    if any(rec.get("mig") for rec in cur.get("tenants", {}).values()):
        return hold("a tenant is mid-migration on a member")
    cluster_qps: dict[str, float] = {cid: 0.0 for cid in
                                     set(placements.values())}
    by_cluster: dict[str, list] = {}
    for tn, cid in placements.items():
        cluster_qps[cid] = cluster_qps.get(cid, 0.0) + qps.get(tn, 0.0)
        by_cluster.setdefault(cid, []).append(tn)
    if len(cluster_qps) < 2:
        return hold("fewer than two clusters see traffic")
    hot = max(cluster_qps, key=lambda c: cluster_qps[c])
    cool = min(cluster_qps, key=lambda c: cluster_qps[c])
    hot_qps, cool_qps = cluster_qps[hot], cluster_qps[cool]
    if hot_qps < min_qps:
        return hold(f"fleet is quiet (hot cluster {hot} at "
                    f"{hot_qps:.1f} qps < {min_qps:g})")
    if hot_qps < hysteresis * max(cool_qps, 1e-9) or hot == cool:
        return hold(f"inside the hysteresis band ({hot} at "
                    f"{hot_qps:.1f} vs {cool} at {cool_qps:.1f} qps, "
                    f"need {hysteresis:g}x)")
    # price the hot cluster's tenants, busiest first; the first GO wins
    cands = sorted(by_cluster.get(hot, []),
                   key=lambda t: qps.get(t, 0.0), reverse=True)
    for tn in cands:
        tqps = qps.get(tn, 0.0)
        if tqps <= 0:
            break
        rec = cur["tenants"].get(tn, {})
        plan = plan_migration(rec.get("applied", 0), tqps,
                              hot_qps, cool_qps, horizon_s=horizon_s)
        if plan["migrate"] == "go":
            return {"action": "migrate", "tenant": tn, "src": hot,
                    "dest": cool, "plan": plan,
                    "reason": plan["reason"]}
    return hold(f"no tenant on {hot} prices out "
                f"(moving any would not shrink the imbalance)")


class Rebalancer:
    """The thread: scrape -> fold -> decide -> (maybe) migrate."""

    def __init__(self, router, interval_s: float | None = None,
                 cooldown_s: float | None = None,
                 hysteresis: float | None = None,
                 min_qps: float | None = None):
        self.router = router
        self.interval_s = interval_s if interval_s is not None else \
            _knob_float(INTERVAL_ENV, DEFAULT_INTERVAL_S)
        self.cooldown_s = cooldown_s if cooldown_s is not None else \
            _knob_float(COOLDOWN_ENV, DEFAULT_COOLDOWN_S)
        self.hysteresis = hysteresis if hysteresis is not None else \
            _knob_float(HYSTERESIS_ENV, DEFAULT_HYSTERESIS)
        self.min_qps = min_qps if min_qps is not None else \
            _knob_float(MIN_QPS_ENV, DEFAULT_MIN_QPS)
        self.verdicts: list[dict] = []
        self.verdict_counts = {"hold": 0, "migrate": 0}
        self.migrations_started = 0
        self._prev: tuple[float, dict] | None = None
        self._last_mig_t: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Rebalancer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rebalancer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _placements(self) -> dict[str, str]:
        """tenant -> cluster for every tenant the last fold saw."""
        prev = self._prev[1] if self._prev else {}
        return {tn: self.router.placement_of(tn)
                for tn in prev.get("tenants", {})}

    def _record(self, verdict: dict) -> None:
        verdict["at"] = time.time()
        self.verdict_counts[verdict.get("action", "hold")] = \
            self.verdict_counts.get(verdict.get("action", "hold"), 0) + 1
        self.verdicts.append(verdict)
        del self.verdicts[:-VERDICT_RING]

    def tick(self) -> dict | None:
        """One scrape+verdict step (the loop body, callable from tests
        without the thread).  None until two folds exist."""
        from ..obs.metrics import parse_prometheus
        body = self.router.fleet_metrics().decode("ascii", "replace")
        cur = fold_fleet(parse_prometheus(body))
        now = time.monotonic()
        prev = self._prev
        self._prev = (now, cur)
        if prev is None:
            return None
        dt = now - prev[0]
        inflight = any(not m.done.is_set()
                       for m in self.router._migrations.values())
        cool_left = 0.0
        if self._last_mig_t is not None:
            cool_left = max(
                0.0, self.cooldown_s - (now - self._last_mig_t))
        verdict = decide(prev[1], cur, dt, self._placements(),
                         hysteresis=self.hysteresis,
                         min_qps=self.min_qps,
                         migration_inflight=inflight,
                         cooldown_remaining_s=cool_left)
        if verdict["action"] == "migrate":
            try:
                self.router.start_migration(verdict["tenant"],
                                            verdict["dest"])
                self.migrations_started += 1
                self._last_mig_t = time.monotonic()
            except ValueError as exc:
                verdict = {"action": "hold",
                           "reason": f"driver refused: {exc}"}
        self._record(verdict)
        return verdict

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # scrape hiccups never kill policy
                self._record({"action": "hold",
                              "reason": f"tick failed: {exc}"})
