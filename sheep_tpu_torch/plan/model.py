"""The build planner (port of sheep_tpu/plan/model.py: the Plan object,
its cost model and ``plan_build``, which the fault-tolerant build driver
and the ``plan`` tool read).

One :func:`plan_build` call per build resolves

  the execution path   the kept rung order (availability x priced
                       feasibility), first kept = the rung that runs
  native threads T     resources.governor.native_thread_plan
  ext/spill block      the governor's fitted ext block, prior-corrected
  handoff windows W    the streamed-tail window policy
  distext legs N       resources.governor.distext_leg_plan
  jump depth / chunking  the lifting-table cap + chunk-loop gates

and records each as a :class:`Decision` carrying its **provenance**:

  ``default``   nothing overrode the built-in policy
  ``priced``    the governor's ANALYTIC cost model changed it (a rung
                skipped, a block halved, a thread count vetoed)
  ``learned``   a measured prior (plan/priors.py — past ``ladder.plan``
                traces, bench records) CORRECTED the analytic answer
  ``forced``    an explicit ``SHEEP_*`` knob or caller argument pinned
                it — the operator's word, never second-guessed

With no prior store configured, every decision is the governor's
analytic answer.  Priors correct only the MEMORY side (keep/skip
verdicts, block fitting); measured seconds are reported beside each
candidate in ``plan --explain`` but never reorder the ladder — rung
order encodes correctness/availability constraints the clock knows
nothing about.  The distext job's leg count (``plan_distext_legs``)
and its transport decision (``plan_transport``) are priced here, and so
are the serving tier's live migration (``plan_migration``), re-sequence
(``plan_reseq``) and scrub (``plan_scrub``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..resources.governor import (EXT_BLOCK_ENV, EXT_BLOCK_FLOOR,
                                  EXT_RECORD_BYTES, NATIVE_THREADS_ENV,
                                  SPILL_BLOCK, ResourceGovernor,
                                  distext_forced_legs, distext_leg_plan,
                                  ext_block_edges, native_thread_plan,
                                  rung_peak_nbytes)
from .priors import PriorStore, mem_ratio

PROV_DEFAULT = "default"
PROV_PRICED = "priced"
PROV_LEARNED = "learned"
PROV_FORCED = "forced"

#: the full degradation ladder (runtime/driver.RuntimeConfig mirrors it)
DEFAULT_LADDER = ("mesh", "single", "host", "stream", "ext", "spill")


@dataclass
class Decision:
    """One resolved knob: what the plan chose, who decided, and why."""

    name: str
    value: object
    provenance: str
    knob: str | None = None       # the SHEEP_* registry knob that forces it
    analytic: object = None       # what the pure-analytic model said
    prior: dict | None = None     # the prior that corrected it
    reason: str = ""

    def to_dict(self) -> dict:
        out = {"name": self.name, "value": self.value,
               "provenance": self.provenance}
        if self.knob:
            out["knob"] = self.knob
        if self.analytic is not None and self.analytic != self.value:
            out["analytic"] = self.analytic
        if self.prior is not None:
            out["prior"] = dict(self.prior)
        if self.reason:
            out["reason"] = self.reason
        return out


@dataclass
class Plan:
    """One build's resolved plan: the kept rung order, every candidate's
    priced-vs-learned cost, and the per-knob decisions."""

    n: int
    links: int
    rungs: list[str]
    candidates: list[dict]
    decisions: dict[str, Decision] = field(default_factory=dict)
    native_threads: dict = field(default_factory=dict)
    headroom_bytes: int | None = None
    budget_bytes: int | None = None
    rss: int | None = None

    @property
    def chosen(self) -> str:
        return self.rungs[0] if self.rungs else "?"

    def decision(self, name: str) -> Decision:
        return self.decisions[name]

    def decisions_dict(self) -> list[dict]:
        return [d.to_dict() for d in self.decisions.values()]

    def corrections(self) -> list[Decision]:
        """The decisions history actually changed (provenance learned)."""
        return [d for d in self.decisions.values()
                if d.provenance == PROV_LEARNED]

    def to_dict(self) -> dict:
        return {
            "n": self.n, "links": self.links,
            "rungs": list(self.rungs), "chosen": self.chosen,
            "candidates": [dict(c) for c in self.candidates],
            "decisions": self.decisions_dict(),
            "headroom_bytes": self.headroom_bytes,
            "budget_bytes": self.budget_bytes,
        }

    def explain(self) -> list[str]:
        """The --explain text: chosen rung, candidate costs (priced vs
        historical), and each decision with its provenance."""
        def fb(x):
            if x is None:
                return "-"
            x = float(x)
            for unit, shift in (("G", 30), ("M", 20), ("K", 10)):
                if abs(x) >= (1 << shift):
                    return f"{x / (1 << shift):.1f}{unit}"
            return f"{int(x)}B"

        lines = [f"plan: n={self.n} links={self.links}"
                 + (f"  budget={fb(self.budget_bytes)} "
                    f"headroom={fb(self.headroom_bytes)}"
                    if self.budget_bytes is not None
                    else "  (unbudgeted)")]
        lines.append(f"chosen rung: {self.chosen}"
                     f"  (ladder {' -> '.join(self.rungs) or '-'})")
        head = (f"  {'RUNG':<8} {'PRICED':>9} {'LEARNED':>9} "
                f"{'HISTORY':>10} VERDICT")
        lines += ["candidates", head]
        for c in self.candidates:
            hist = c.get("prior_s")
            hist_s = f"{hist['mean']:.2f}s*{hist['count']}" if hist else "-"
            corrected = c.get("corrected_bytes")
            lines.append(
                f"  {c['rung']:<8} {fb(c.get('est_bytes')):>9} "
                f"{(fb(corrected) if corrected is not None else '-'):>9} "
                f"{hist_s:>10} {c['verdict']}"
                + (f"  [prior {c['prior']['key']} x{c['prior']['mean']:.2f}]"
                   if c.get("prior") else ""))
        lines.append("decisions")
        for d in self.decisions.values():
            line = f"  {d.name:<16} = {d.value!r:<12} [{d.provenance}]"
            if d.knob:
                line += f" knob {d.knob}"
            if d.provenance == PROV_LEARNED and d.analytic is not None:
                line += f"  (analytic said {d.analytic!r}"
                if d.prior:
                    line += (f"; corrected by prior {d.prior['key']} "
                             f"mean x{d.prior['mean']:.2f} "
                             f"over {d.prior['count']} run(s)")
                line += ")"
            elif d.reason:
                line += f"  ({d.reason})"
            lines.append(line)
        for d in self.corrections():
            lines.append(f"history corrected: {d.name} {d.analytic!r} -> "
                         f"{d.value!r} via {d.prior['key'] if d.prior else '?'}")
        return lines


def available_rungs(ladder=DEFAULT_LADDER, devices: int | None = None,
                    num_workers: int | None = None,
                    edges_path: str | None = None,
                    known=None) -> list[str]:
    """Availability filter (the driver's pre-plan step): drop mesh
    without >= 2 devices/workers, drop ext without a whole-input .dat.
    Pure function of its arguments — the driver passes the live device
    count (and its registered rung set: tests install synthetic rungs),
    the CLI passes what it knows."""
    known = set(DEFAULT_LADDER) if known is None else set(known)
    rungs = [r for r in ladder if r in known]
    if (devices is not None and devices < 2) \
            or (num_workers is not None and num_workers < 2):
        rungs = [r for r in rungs if r != "mesh"]
    if not (edges_path and edges_path.endswith(".dat")
            and os.path.exists(edges_path)):
        rungs = [r for r in rungs if r != "ext"]
    return rungs or ["host"]


def _fit_ext_block(n: int, head: int | None, ratio: float) -> int:
    """The governor's ext-block fitting loop (ext_fitted_block) with a
    measured-prior correction factor on the priced peak.  ratio=1.0
    reproduces the analytic fit bit for bit."""
    block = ext_block_edges()
    if os.environ.get(EXT_BLOCK_ENV, ""):
        return block  # pinned: the operator's word, resume identity
    if head is None:
        return block
    while block > EXT_BLOCK_FLOOR \
            and ratio * (32 * n + EXT_RECORD_BYTES * block) > head:
        block //= 2
    return block


def plan_build(n: int, links: int, *,
               rungs: list[str] | None = None,
               ladder=DEFAULT_LADDER, ladder_forced: bool = False,
               governor: ResourceGovernor | None = None,
               num_workers: int | None = None,
               devices: int | None = None,
               edges_path: str | None = None,
               priors: PriorStore | None = None,
               platform: str = "cpu",
               assume_rss: int | None = None,
               with_distext: bool = False) -> Plan:
    """Resolve one build's plan.  ``rungs`` (already availability- and
    resume-filtered) skips the filter; ``priors`` defaults to the
    ``SHEEP_PLAN_PRIORS`` store (None when unset — pure analytic);
    ``assume_rss`` pins the measured-RSS input so a plan can be
    reproduced deterministically (the CLI's --assume-rss).  ``platform``
    is the build's device type ("cuda" or "cpu"), which sets the
    handoff-window default as ``device.type`` does in ops/build.py."""
    gov = governor if governor is not None else ResourceGovernor.from_env()
    if priors is None:
        priors = PriorStore.from_env()
    if rungs is None:
        rungs = available_rungs(ladder, devices, num_workers, edges_path)
    rss = assume_rss if assume_rss is not None else None
    if assume_rss is not None:
        head = gov.mem_budget - assume_rss \
            if gov.mem_budget is not None else None
    else:
        # through the governor, not a private rss read: deterministic
        # harnesses monkeypatch governor.rss_bytes and the plan must see
        # the same world the governor does
        head = gov.mem_headroom()

    decisions: dict[str, Decision] = {}

    # -- native threads (governor arithmetic; provenance from its reason)
    tplan = native_thread_plan(n, gov)
    t = tplan["threads"]
    if tplan["forced"]:
        t_prov = PROV_FORCED
    elif "vetoed" in tplan["reason"] or "leg cores" in tplan["reason"]:
        t_prov = PROV_PRICED
    else:
        t_prov = PROV_DEFAULT
    decisions["native_threads"] = Decision(
        "native_threads", t, t_prov, knob=NATIVE_THREADS_ENV,
        reason=tplan["reason"])

    # -- ext block: analytic fit vs prior-corrected fit
    ext_prior = mem_ratio(priors, "ext", n)
    analytic_block = _fit_ext_block(n, head, 1.0)
    block = _fit_ext_block(n, head, ext_prior["mean"]) if ext_prior \
        else analytic_block
    if os.environ.get(EXT_BLOCK_ENV, ""):
        b_prov, b_reason = PROV_FORCED, f"pinned by {EXT_BLOCK_ENV}"
    elif ext_prior and block != analytic_block:
        b_prov = PROV_LEARNED
        b_reason = (f"measured rss ran x{ext_prior['mean']:.2f} the "
                    f"analytic price on this host")
    elif block != ext_block_edges():
        b_prov = PROV_PRICED
        b_reason = "halved to the memory headroom"
    else:
        b_prov, b_reason = PROV_DEFAULT, ""
    decisions["ext_block"] = Decision(
        "ext_block", block, b_prov, knob=EXT_BLOCK_ENV,
        analytic=analytic_block,
        prior=ext_prior if b_prov == PROV_LEARNED else None,
        reason=b_reason)

    # -- rung pricing: the governor's plan_rungs loop, prior-corrected.
    # The last rung always survives (something must run).
    candidates: list[dict] = []
    kept: list[str] = []
    verdict_changed = False
    any_skip = False
    for i, rung in enumerate(rungs):
        try:
            est = rung_peak_nbytes(
                rung, n, links, num_workers or 1,
                ext_block=block if rung == "ext" else None,
                threads=t)
        except ValueError:
            # a rung the cost model does not know (tests install
            # synthetic rungs): unpriceable, never skipped
            cand = {"rung": rung, "est_bytes": None, "verdict": "keep"}
            kept.append(rung)
            candidates.append(cand)
            continue
        prior = mem_ratio(priors, rung, n)
        corrected = int(est * prior["mean"]) if prior else None
        effective = corrected if corrected is not None else est
        cand = {"rung": rung, "est_bytes": int(est), "verdict": "keep"}
        if corrected is not None:
            cand["corrected_bytes"] = corrected
            cand["prior"] = prior
        ps = priors.lookup("rung_s", rung, links) if priors else None
        if ps:
            cand["prior_s"] = ps
        if head is not None and effective > head and i < len(rungs) - 1:
            cand["verdict"] = "skip"
            any_skip = True
            if est <= head:
                verdict_changed = True  # analytic said keep; history said no
        else:
            if head is not None and est > head \
                    and effective <= head and i < len(rungs) - 1:
                verdict_changed = True  # history rescued an analytic skip
            kept.append(rung)
        candidates.append(cand)
    if ladder_forced:
        r_prov, r_reason = PROV_FORCED, "ladder pinned by the caller"
    elif verdict_changed:
        r_prov = PROV_LEARNED
        r_reason = "a measured prior changed a keep/skip verdict"
    elif any_skip:
        r_prov, r_reason = PROV_PRICED, "governor-priced rungs skipped"
    else:
        r_prov, r_reason = PROV_DEFAULT, ""
    decisions["rungs"] = Decision(
        "rungs", list(kept), r_prov, knob=None,
        analytic=[r for i, r in enumerate(rungs)
                  if head is None
                  or candidates[i]["est_bytes"] is None
                  or candidates[i]["est_bytes"] <= head
                  or i == len(rungs) - 1],
        prior=next((c["prior"] for c in candidates
                    if c.get("prior") and r_prov == PROV_LEARNED), None),
        reason=r_reason)

    # -- handoff windows (ops/build.handoff_windows policy, torch-free)
    wv = os.environ.get("SHEEP_HANDOFF_WINDOWS", "")
    if wv != "":
        w, w_prov = max(1, int(wv)), PROV_FORCED
    elif platform == "cpu":
        w, w_prov = 1, PROV_DEFAULT
    else:
        w, w_prov = (4 if links >= (1 << 20) else 1), PROV_DEFAULT
    decisions["handoff_windows"] = Decision(
        "handoff_windows", w, w_prov, knob="SHEEP_HANDOFF_WINDOWS")

    # -- jump-table depth cap (the chunk drivers' lv ceiling)
    levels = gov.shrunk_levels(10, n) if gov.active else 10
    decisions["levels"] = Decision(
        "levels", levels,
        PROV_PRICED if levels < 10 else PROV_DEFAULT, knob=None,
        analytic=10,
        reason="jump tables shrunk to headroom" if levels < 10 else "")

    # -- chunk-loop gates (recorded overrides; the loops read them live)
    for name, knob, dflt in (("pipeline_chunks", "SHEEP_PIPELINE_CHUNKS",
                              "1"),
                             ("plateau_adapt", "SHEEP_PLATEAU_ADAPT",
                              "1")):
        v = os.environ.get(knob, "")
        decisions[name] = Decision(
            name, (v or dflt) != "0",
            PROV_FORCED if v != "" else PROV_DEFAULT, knob=knob)

    # -- spill block (compile-time constant today; recorded so --explain
    # shows the whole surface)
    decisions["spill_block"] = Decision(
        "spill_block", SPILL_BLOCK, PROV_DEFAULT, knob=None)

    # -- distext legs (only meaningful with a whole-input file, but the
    # decision is cheap and the provenance story should be complete)
    if with_distext or distext_forced_legs():
        forced_legs = distext_forced_legs()
        dplan = distext_leg_plan(n, gov)
        if forced_legs:
            d_prov, d_reason = PROV_FORCED, "pinned by SHEEP_DISTEXT_LEGS"
        else:
            free = distext_leg_plan(
                n, ResourceGovernor(mem_budget=None,
                                    disk_budget=gov.disk_budget,
                                    scratch_dir=gov.scratch_dir))
            d_prov = PROV_PRICED if dplan["legs"] < free["legs"] \
                else PROV_DEFAULT
            d_reason = ("cut to the aggregate per-leg budget"
                        if d_prov == PROV_PRICED else "")
        decisions["distext_legs"] = Decision(
            "distext_legs", dplan["legs"], d_prov,
            knob="SHEEP_DISTEXT_LEGS", reason=d_reason)

    return Plan(n=n, links=links, rungs=kept, candidates=candidates,
                decisions=decisions, native_threads=dict(tplan),
                headroom_bytes=head, budget_bytes=gov.mem_budget,
                rss=rss)


def plan_distext_legs(n: int = 0,
                      governor: ResourceGovernor | None = None,
                      priors: PriorStore | None = None) -> dict:
    """The distext leg planner, routed through the plan layer: the
    governor's arithmetic (distext_leg_plan) plus the decision
    record.  Returns the governor dict EXTENDED with ``provenance`` —
    existing consumers (ops/distext.run_distext) read the same keys."""
    gov = governor if governor is not None else ResourceGovernor.from_env()
    out = distext_leg_plan(n, gov)
    if out["forced"]:
        out["provenance"] = PROV_FORCED
    else:
        free = distext_leg_plan(
            n, ResourceGovernor(mem_budget=None,
                                disk_budget=gov.disk_budget,
                                scratch_dir=gov.scratch_dir))
        out["provenance"] = PROV_PRICED if out["legs"] < free["legs"] \
            else PROV_DEFAULT
    return out


#: the transport cost model's assumed bandwidths: sequential
#: local disk stream vs one worker-wire crossing.  Deliberately coarse
#: round numbers — the decision only has to be right about the SHAPE
#: (waves of legs over cores vs waves over workers), and the pin knob
#: (SHEEP_WORKER_TRANSPORT) is the operator's word when it is not.
TRANSPORT_DISK_BPS = 256 << 20
TRANSPORT_WIRE_BPS = 128 << 20

#: pin the per-leg transport decision: "ship" | "local" | "" (priced)
WORKER_TRANSPORT_ENV = "SHEEP_WORKER_TRANSPORT"


def plan_transport(records: int, legs: int, remote_workers: int,
                   pin: str | None = None,
                   host_cores: int | None = None) -> dict:
    """Price network-ship vs local-disk dispatch for the distext legs
    (the transport decision recorded in the ``distext.plan`` event).

    The model (PERF_NOTES "network-ship vs local-disk pricing rule"):
    a LOCAL leg streams its slice from the supervisor's disk, and the
    legs time-share the host — cost ~= ceil(legs / host_cores) waves of
    ``slice_bytes / DISK_BPS``.  A SHIPPED leg pays one wire crossing,
    then folds on a worker's own core; crossings pipeline with the
    previous wave's folds (the prefetch-overlap shape), so cost ~=
    ceil(legs / workers) disk-speed waves plus ONE un-overlapped first
    crossing.  Ship wins only when it is STRICTLY cheaper — on a tie the
    bytes stay home.  No remote workers configured = "local" by default;
    ``SHEEP_WORKER_TRANSPORT`` pins either way (provenance "forced")."""
    if pin is None:
        pin = os.environ.get(WORKER_TRANSPORT_ENV, "")
    legs = max(1, int(legs))
    per_leg_bytes = (max(0, int(records)) * 12) // legs
    out = {"per_leg_bytes": per_leg_bytes, "remote_workers":
           int(remote_workers), "ship_s": None, "local_s": None,
           "reason": ""}
    if pin in ("ship", "local"):
        out.update(transport=pin, provenance=PROV_FORCED,
                   reason=f"pinned by {WORKER_TRANSPORT_ENV}")
        return out
    if pin:
        raise ValueError(f"{WORKER_TRANSPORT_ENV}={pin!r} must be "
                         f"'ship' or 'local'")
    if remote_workers < 1:
        out.update(transport="local", provenance=PROV_DEFAULT,
                   reason="no remote workers configured")
        return out
    if host_cores is None:
        try:
            host_cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            host_cores = os.cpu_count() or 1
    stream_s = per_leg_bytes / TRANSPORT_DISK_BPS
    wire_s = per_leg_bytes / TRANSPORT_WIRE_BPS
    local_waves = -(-legs // max(1, host_cores))
    ship_waves = -(-legs // max(1, remote_workers))
    local_s = local_waves * stream_s
    ship_s = ship_waves * stream_s + wire_s
    out.update(ship_s=round(ship_s, 6), local_s=round(local_s, 6))
    if ship_s < local_s:
        out.update(transport="ship", provenance=PROV_PRICED,
                   reason=f"{remote_workers} worker(s) beat "
                          f"{host_cores} local core(s): "
                          f"{ship_waves} shipped wave(s) + one wire "
                          f"crossing < {local_waves} local wave(s)")
    else:
        out.update(transport="local", provenance=PROV_PRICED,
                   reason="shipping the slices does not beat the local "
                          "disk waves")
    return out


#: pin the rebalancer's migrate decision: "go" | "stay" | "" (priced)
REBALANCE_PIN_ENV = "SHEEP_REBALANCE_PIN"


def plan_migration(records: int, tenant_qps: float, src_qps: float,
                   dest_qps: float, pin: str | None = None,
                   horizon_s: float = 60.0) -> dict:
    """Price a live tenant migration for the rebalancer
    (serve/rebalance.py): is moving this tenant from its hot cluster to
    the cool one worth the transfer?

    The model reuses the transport bandwidth constants: the phase-1
    snapshot pays one wire crossing plus one local landing stream
    (``bytes/WIRE + bytes/DISK``); the phase-2 delta rides under live
    traffic and the phase-3 cutover is fenced milliseconds, so the
    snapshot dominates.  GO only when BOTH hold: the qps imbalance
    between the clusters strictly SHRINKS after the move (otherwise the
    migration is churn, not balance), and the transfer amortizes inside
    ``horizon_s`` of the imbalance it removes.  Ties stay home — the
    same strictly-cheaper discipline as :func:`plan_transport`.
    ``SHEEP_REBALANCE_PIN`` is the operator's word (provenance
    "forced"); the rebalancer's own hysteresis/cooldown gates run
    BEFORE this pricing, not inside it."""
    if pin is None:
        pin = os.environ.get(REBALANCE_PIN_ENV, "")
    blob = max(0, int(records)) * 12
    out = {"blob_bytes": blob, "tenant_qps": round(tenant_qps, 3),
           "src_qps": round(src_qps, 3),
           "dest_qps": round(dest_qps, 3),
           "cost_s": None, "reason": ""}
    if pin in ("go", "stay"):
        out.update(migrate=pin, provenance=PROV_FORCED,
                   reason=f"pinned by {REBALANCE_PIN_ENV}")
        return out
    if pin:
        raise ValueError(f"{REBALANCE_PIN_ENV}={pin!r} must be "
                         f"'go' or 'stay'")
    cost_s = blob / TRANSPORT_WIRE_BPS + blob / TRANSPORT_DISK_BPS
    out["cost_s"] = round(cost_s, 6)
    before = abs(src_qps - dest_qps)
    after = abs((src_qps - tenant_qps) - (dest_qps + tenant_qps))
    out["imbalance_before"] = round(before, 3)
    out["imbalance_after"] = round(after, 3)
    if tenant_qps <= 0 or after >= before:
        out.update(migrate="stay", provenance=PROV_DEFAULT,
                   reason="moving this tenant does not shrink the "
                          "cluster qps imbalance")
        return out
    if cost_s > horizon_s:
        out.update(migrate="stay", provenance=PROV_PRICED,
                   reason=f"snapshot transfer ({cost_s:.1f}s) does not "
                          f"amortize inside the {horizon_s:g}s horizon")
        return out
    out.update(migrate="go", provenance=PROV_PRICED,
               reason=f"imbalance {before:.1f} -> {after:.1f} qps for a "
                      f"{cost_s:.2f}s transfer")
    return out


#: pin the re-sequence decision: "go" | "stay" | "" (priced)
RESEQ_PIN_ENV = "SHEEP_RESEQ_PIN"
#: amortization horizon for the rebuild (seconds)
RESEQ_HORIZON_ENV = "SHEEP_RESEQ_HORIZON_S"
#: assumed carry-fold throughput of the streamed rebuild — deliberately
#: coarse (same discipline as TRANSPORT_*): the decision only has to be
#: right about the SHAPE (a rebuild is seconds, not hours), and
#: SHEEP_RESEQ_PIN is the operator's word when it is not
RESEQ_FOLD_BPS = 64 << 20


def plan_reseq(records: int, inserted: int, seq_drift: int,
               pin: str | None = None,
               horizon_s: float | None = None,
               priors=None) -> dict:
    """Price a full re-sequence rebuild for the serve tier (serve/reseq.py): the detector already fired — is the streamed fold
    over ``.dat + log`` worth running NOW?

    The model: the rebuild streams ``(records + inserted) * 12`` bytes
    off local disk and folds them (``bytes/DISK + bytes/FOLD``); the
    counting-sort sequence pass and the partition sweep are noise beside
    the fold.  GO when the rebuild amortizes inside ``horizon_s`` AND
    there is real drift to recover (``seq_drift > 0``) — a drift-free
    forced rebuild is the operator's call (``SHEEP_RESEQ_PIN=go`` or the
    RESEQ verb's force), not the planner's.  The daemon's own detector
    gates (SHEEP_RESEQ_DRIFT / _DRIFT_MIN) run BEFORE this pricing,
    exactly like the rebalancer's hysteresis.

    ``priors`` (a plan/priors.py PriorStore) replaces the analytic
    RESEQ_FOLD_BPS guess with this host's MEASURED fold throughput —
    harvested from past ``reseq.fold`` trace spans, the way plan_build
    learns rung seconds.  The decision then carries provenance
    ``learned``; when history thins (< MIN_CORRECT_SAMPLES at this
    scale) the analytic constant is the fallback, same as everywhere."""
    if pin is None:
        pin = os.environ.get(RESEQ_PIN_ENV, "")
    if horizon_s is None:
        horizon_s = float(os.environ.get(RESEQ_HORIZON_ENV, "") or 60.0)
    blob = (max(0, int(records)) + max(0, int(inserted))) * 12
    out = {"blob_bytes": blob, "records": max(0, int(records)),
           "inserted": max(0, int(inserted)),
           "seq_drift": max(0, int(seq_drift)),
           "cost_s": None, "reason": ""}
    if pin in ("go", "stay"):
        out.update(decision=pin, provenance=PROV_FORCED,
                   reason=f"pinned by {RESEQ_PIN_ENV}")
        return out
    if pin:
        raise ValueError(f"{RESEQ_PIN_ENV}={pin!r} must be "
                         f"'go' or 'stay'")
    from .priors import fold_bps as _fold_bps
    prior = _fold_bps(priors, blob)
    bps = prior["mean"] if prior else RESEQ_FOLD_BPS
    cost_s = blob / TRANSPORT_DISK_BPS + blob / bps
    out["cost_s"] = round(cost_s, 6)
    out["fold_bps"] = int(bps)
    priced_prov = PROV_LEARNED if prior else PROV_PRICED
    learned = (f" (measured fold {bps / (1 << 20):.0f} MB/s over "
               f"{prior['count']} run(s))" if prior else "")
    if prior:
        out["prior"] = prior
        out["analytic_cost_s"] = round(
            blob / TRANSPORT_DISK_BPS + blob / RESEQ_FOLD_BPS, 6)
    if seq_drift <= 0:
        out.update(decision="stay", provenance=PROV_DEFAULT,
                   reason="no sequence drift to recover")
        return out
    if cost_s > horizon_s:
        out.update(decision="stay", provenance=priced_prov,
                   reason=f"rebuild ({cost_s:.1f}s) does not amortize "
                          f"inside the {horizon_s:g}s horizon" + learned)
        return out
    out.update(decision="go", provenance=priced_prov,
               reason=f"{seq_drift} drifted insert(s) recovered for a "
                      f"{cost_s:.2f}s streamed rebuild" + learned)
    return out


# -- the anti-entropy scrub job (serve/scrub.py) ------------------

SCRUB_PIN_ENV = "SHEEP_SCRUB_PIN"
#: the budget one background scrub pass may spend re-reading sealed bytes
SCRUB_HORIZON_ENV = "SHEEP_SCRUB_HORIZON_S"
#: crc32c re-verification throughput (memory-bound streaming checksum;
#: conservative so pricing declines before the disk does)
SCRUB_SUM_BPS = 512 << 20


def plan_scrub(artifacts: int, bytes_total: int,
               pin: str | None = None,
               horizon_s: float | None = None) -> dict:
    """Price one background scrub pass: re-reading every
    sealed artifact costs ``bytes/DISK + bytes/SUM`` — GO when that fits
    inside ``horizon_s`` (default 30s), else STAY and let the operator
    raise the horizon, tighten the interval, or pin.  The daemon's
    interval knob (SHEEP_SCRUB_INTERVAL_S) gates WHEN pricing runs,
    exactly like the reseq detector gates plan_reseq; an inline ``SCRUB``
    verb is the operator's force and skips pricing entirely."""
    if pin is None:
        pin = os.environ.get(SCRUB_PIN_ENV, "")
    if horizon_s is None:
        horizon_s = float(os.environ.get(SCRUB_HORIZON_ENV, "") or 30.0)
    blob = max(0, int(bytes_total))
    out = {"artifacts": max(0, int(artifacts)), "blob_bytes": blob,
           "cost_s": None, "reason": ""}
    if pin in ("go", "stay"):
        out.update(decision=pin, provenance=PROV_FORCED,
                   reason=f"pinned by {SCRUB_PIN_ENV}")
        return out
    if pin:
        raise ValueError(f"{SCRUB_PIN_ENV}={pin!r} must be "
                         f"'go' or 'stay'")
    if not artifacts:
        out.update(decision="stay", provenance=PROV_DEFAULT,
                   reason="nothing sealed to re-verify")
        return out
    cost_s = blob / TRANSPORT_DISK_BPS + blob / SCRUB_SUM_BPS
    out["cost_s"] = round(cost_s, 6)
    if cost_s > horizon_s:
        out.update(decision="stay", provenance=PROV_PRICED,
                   reason=f"re-verifying {blob >> 20} MiB "
                          f"({cost_s:.1f}s) exceeds the {horizon_s:g}s "
                          f"scrub horizon")
        return out
    out.update(decision="go", provenance=PROV_PRICED,
               reason=f"{artifacts} sealed artifact(s), "
                      f"{cost_s:.2f}s to re-verify")
    return out
