"""Measured priors for the planner: learn from what past builds did.

The governor's analytic estimates (resources/governor.py) are
first-principles arithmetic — deliberately coarse, deliberately
over-priced.  Every build leaves evidence of what ACTUALLY happened: the
``ladder.plan`` event records each rung's priced peak and ``rung.ok``
records the measured RSS beside it (runtime/driver.py).  A small on-disk
:class:`PriorStore` (the reference's format) holds per-host per-scale
statistics learned from such traces; the planner (plan/model.py) reads

  ``mem_ratio:<rung>``   measured_rss / priced_bytes of a finished rung —
                         the correction factor for the analytic peak.
                         >1 means the analytic model under-prices on this
                         host; the planner multiplies it in before
                         keep/skip verdicts and ext-block fitting.
  ``rung_s:<rung>``      measured seconds of a ``rung`` span (and of
                         bench arms whose name matches a rung), bucketed
                         by link scale — the historical cost ``plan
                         --explain`` prints beside each candidate's
                         analytic price.
  ``fold_bps:reseq``     measured bytes/s of a serve-tier re-sequence
                         fold (``reseq.fold`` spans, serve/reseq.py) —
                         replaces the analytic RESEQ_FOLD_BPS guess in
                         ``plan_reseq`` once this host has history.

Keys carry a **host fingerprint** (cpu model + effective cores) and a
**scale bucket** (log2 of n or links): a prior learned on an 8-core
bench host never corrects a plan on a 1-core container, and a prior
from a 2^14 toy never corrects a 2^26 build.

Trace harvesting (``plan --harvest``) reads through the ROTATED segment
chain (obs/trace.py: ``x.trace`` -> ``x.0001.trace`` ...), with the
newest segment read in repair mode — the active file of a killed run
legally ends in a torn line, and history includes crashes.  A mid-chain
rotten segment is skipped, never fatal: a prior store degrades to fewer
samples, not to a refusal.  Bench records (``*BENCH*.json``-shaped)
contribute their rung-named arms' wall clocks.

The store itself is one JSON file (``SHEEP_PLAN_PRIORS`` names it),
written atomically; absent/corrupt stores read as empty — priors can
only ever ADD information to the analytic model, never break a build.
"""

from __future__ import annotations

import hashlib
import json
import os

PRIORS_ENV = "SHEEP_PLAN_PRIORS"
STORE_VERSION = 1

#: samples a prior needs before it may CORRECT a decision (a single
#: noisy run must not flip plans; --explain still shows thinner priors)
MIN_CORRECT_SAMPLES = 2


def host_fingerprint() -> str:
    """A stable id of "this kind of host" for prior keys: cpu model x
    effective cores.  Deliberately coarse — two identical containers
    should share priors; a quota change is a different host."""
    from ..utils.envinfo import effective_cores, env_capture
    cap = env_capture()
    raw = f"{cap.get('cpu_model', '?')}|{effective_cores()}"
    return hashlib.sha1(raw.encode()).hexdigest()[:12]


def scale_bucket(size: int) -> int:
    """log2 bucket of a problem size (n or links); 0 for empty."""
    return max(0, int(size).bit_length() - 1) if size > 0 else 0


def prior_key(kind: str, name: str, size: int, host: str | None = None
              ) -> str:
    host = host if host is not None else host_fingerprint()
    return f"{host}:{kind}:{name}:s{scale_bucket(size)}"


class PriorStore:
    """The on-disk prior store: {key: {"count": k, "mean": m}} plus a
    version stamp.  ``observe`` folds a sample into the running mean;
    ``lookup`` answers for one (kind, name, size) on this host."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.entries: dict[str, dict] = {}
        self.meta: dict = {"v": STORE_VERSION}
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                if isinstance(data, dict) \
                        and isinstance(data.get("entries"), dict):
                    self.entries = {
                        str(k): {"count": int(v.get("count", 0)),
                                 "mean": float(v.get("mean", 0.0))}
                        for k, v in data["entries"].items()
                        if isinstance(v, dict)}
            except (OSError, ValueError):
                pass  # a corrupt store reads as empty, never breaks

    @classmethod
    def from_env(cls) -> "PriorStore | None":
        path = os.environ.get(PRIORS_ENV) or None
        return cls(path) if path else None

    def __len__(self) -> int:
        return len(self.entries)

    def observe(self, kind: str, name: str, size: int, value: float,
                host: str | None = None) -> None:
        key = prior_key(kind, name, size, host)
        e = self.entries.setdefault(key, {"count": 0, "mean": 0.0})
        e["count"] += 1
        e["mean"] += (float(value) - e["mean"]) / e["count"]

    # -- harvesting --------------------------------------------------------

    def harvest_trace(self, path: str, host: str | None = None) -> int:
        """Fold one trace (or its rotated segment chain) into the store;
        returns samples observed.  Rotated segments read strict, the
        newest file in repair (a killed run's torn tail is legal
        evidence); a rotten segment is skipped with its samples lost —
        harvesting never raises over damage."""
        from ..integrity.errors import IntegrityError
        from ..obs.trace import read_trace, trace_segments
        host = host if host is not None else host_fingerprint()
        chain = trace_segments(path)
        if not chain:
            return 0
        records: list[dict] = []
        import warnings
        for i, seg in enumerate(chain):
            mode = "repair" if i == len(chain) - 1 else "strict"
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    recs, _, _ = read_trace(seg, mode)
            except (IntegrityError, OSError):
                continue  # damaged segment: fewer samples, not a refusal
            records.extend(recs)
        return self._harvest_records(records, host)

    def _harvest_records(self, records: list[dict], host: str) -> int:
        seen = 0
        # the newest ladder.plan's n/links/rss contextualize later rung
        # events: the plan-time rss is the baseline the rung's measured
        # rss is charged against — raw process RSS includes the
        # interpreter+backend floor, which is not the rung's doing and
        # would swamp the ratio at small scales
        n = links = 0
        rss0 = None
        for r in records:
            k, name = r.get("k"), r.get("name")
            a = r.get("a", {})
            if k == "ev" and name == "ladder.plan":
                n = int(a.get("n") or 0)
                links = int(a.get("links") or 0)
                rss0 = a.get("rss_bytes")
            elif k == "ev" and name == "rung.ok":
                est, rss = a.get("est_bytes"), a.get("rss_bytes")
                size = int(a.get("n") or n)
                if est and rss is not None and rss0 is not None and size:
                    inc = float(rss) - float(rss0)
                    # clamp: a single run's allocator noise must not
                    # teach an unbounded correction either way
                    ratio = min(8.0, max(0.125, inc / float(est)))
                    self.observe("mem_ratio", str(a.get("rung", "?")),
                                 size, ratio, host)
                    seen += 1
            elif k == "span" and name == "rung":
                rung = a.get("rung")
                size = int(a.get("links") or links)
                dur = float(r.get("dur", 0.0))
                if rung and size and dur > 0:
                    self.observe("rung_s", str(rung), size, dur, host)
                    seen += 1
            elif k == "span" and name == "reseq.fold":
                b = int(a.get("bytes") or 0)
                dur = float(r.get("dur", 0.0))
                if b > 0 and dur > 0:
                    self.observe("fold_bps", "reseq", b, b / dur, host)
                    seen += 1
        return seen

    def harvest_bench(self, path: str, host: str | None = None) -> int:
        """Fold one bench record (``BENCH_*``/``EXTBENCH_*.json``-shaped)
        into the store: arms whose name matches a ladder rung contribute
        ``rung_s`` seconds at their record scale.  Unknown shapes
        harvest zero samples; damage never raises."""
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return 0
        if not isinstance(rec, dict):
            return 0
        host = host if host is not None else host_fingerprint()
        rungs = {"mesh", "single", "host", "stream", "ext", "spill"}
        seen = 0
        arms = rec.get("arms")
        if isinstance(arms, dict):
            for name, arm in arms.items():
                if not isinstance(arm, dict):
                    continue
                rung = str(arm.get("arm", name)).split("_")[0]
                wall = arm.get("wall_s")
                size = arm.get("records") or arm.get("edges") \
                    or arm.get("links") or 0
                if rung in rungs and wall and size:
                    self.observe("rung_s", rung, int(size), float(wall),
                                 host)
                    seen += 1
        return seen

    def lookup(self, kind: str, name: str, size: int,
               host: str | None = None) -> dict | None:
        """The prior for (kind, name, size-bucket) on ``host`` (default:
        this host), as {"key", "count", "mean"} — or None."""
        key = prior_key(kind, name, size, host)
        e = self.entries.get(key)
        if e is None:
            return None
        return {"key": key, "count": e["count"], "mean": e["mean"]}

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("PriorStore has no path to save to")
        from ..io.atomic import atomic_write
        payload = json.dumps({"v": STORE_VERSION, "entries": self.entries},
                             indent=1, sort_keys=True)
        with atomic_write(path, "w") as f:
            f.write(payload)
        self.path = path
        return path


def mem_ratio(priors: "PriorStore | None", rung: str, n: int) -> dict | None:
    """The usable memory-correction prior for ``rung`` at scale ``n`` on
    this host, or None (no store / too few samples to correct)."""
    if priors is None:
        return None
    p = priors.lookup("mem_ratio", rung, n)
    if p is None or p["count"] < MIN_CORRECT_SAMPLES or p["mean"] <= 0:
        return None
    return p


def fold_bps(priors: "PriorStore | None", blob: int) -> dict | None:
    """The usable measured fold-throughput prior (bytes/s) for a
    re-sequence of ``blob`` bytes on this host, or None (no store / too
    few samples to correct)."""
    if priors is None:
        return None
    p = priors.lookup("fold_bps", "reseq", blob)
    if p is None or p["count"] < MIN_CORRECT_SAMPLES or p["mean"] <= 0:
        return None
    return p
