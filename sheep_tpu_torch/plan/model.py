"""The build planner (port of sheep_tpu/plan/model.py: ``available_rungs``
and the part of ``plan_build`` the fault-tolerant build driver reads).

One :func:`plan_build` call per build resolves

  the execution path   the kept rung order (availability x priced
                       feasibility), first kept = the rung that runs
  native threads T     resources.governor.native_thread_plan

and records each as a :class:`Decision` carrying its **provenance**:

  ``default``   nothing overrode the built-in policy
  ``priced``    the governor's ANALYTIC cost model changed it (a rung
                skipped, a thread count vetoed)
  ``learned``   a measured prior (plan/priors.py) CORRECTED the analytic
                answer
  ``forced``    an explicit ``SHEEP_*`` knob or caller argument pinned
                it — the operator's word, never second-guessed

With no prior store configured, every decision is the governor's
analytic answer.  Priors correct only the MEMORY side (keep/skip
verdicts); measured seconds never reorder the ladder — rung order
encodes correctness/availability constraints the clock knows nothing
about.  The reference's ext-block, handoff-window, depth, chunk-gate and
distext decisions come with the slices that run them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..resources.governor import (NATIVE_THREADS_ENV, ResourceGovernor,
                                  native_thread_plan, rung_peak_nbytes)
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

    def decisions_dict(self) -> list[dict]:
        return [d.to_dict() for d in self.decisions.values()]


def available_rungs(ladder=DEFAULT_LADDER, devices: int | None = None,
                    num_workers: int | None = None,
                    known=None) -> list[str]:
    """Availability filter (the driver's pre-plan step): drop mesh
    without >= 2 devices/workers, and drop ext, which the port does not
    run yet (the reference keeps it only with a whole-input .dat).  Pure
    function of its arguments — the driver passes the live device count
    and its registered rung set (tests install synthetic rungs)."""
    known = set(DEFAULT_LADDER) if known is None else set(known)
    rungs = [r for r in ladder if r in known and r != "ext"]
    if (devices is not None and devices < 2) \
            or (num_workers is not None and num_workers < 2):
        rungs = [r for r in rungs if r != "mesh"]
    return rungs or ["host"]


def plan_build(n: int, links: int, *,
               rungs: list[str] | None = None,
               ladder=DEFAULT_LADDER, ladder_forced: bool = False,
               governor: ResourceGovernor | None = None,
               num_workers: int | None = None,
               devices: int | None = None,
               priors: PriorStore | None = None,
               assume_rss: int | None = None) -> Plan:
    """Resolve one build's plan.  ``rungs`` (already availability- and
    resume-filtered) skips the filter; ``priors`` defaults to the
    ``SHEEP_PLAN_PRIORS`` store (None when unset — pure analytic);
    ``assume_rss`` pins the measured-RSS input so a plan can be
    reproduced deterministically."""
    gov = governor if governor is not None else ResourceGovernor.from_env()
    if priors is None:
        priors = PriorStore.from_env()
    if rungs is None:
        rungs = available_rungs(ladder, devices, num_workers)
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

    # -- rung pricing: each rung's analytic peak (rung_peak_nbytes)
    # against the headroom, prior-corrected.
    # The last rung always survives (something must run).
    candidates: list[dict] = []
    kept: list[str] = []
    verdict_changed = False
    any_skip = False
    for i, rung in enumerate(rungs):
        try:
            est = rung_peak_nbytes(
                rung, n, links, num_workers or 1, threads=t)
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

    return Plan(n=n, links=links, rungs=kept, candidates=candidates,
                decisions=decisions, native_threads=dict(tplan),
                headroom_bytes=head)
