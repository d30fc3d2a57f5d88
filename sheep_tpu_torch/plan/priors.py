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
                         keep/skip verdicts.

Keys carry a **host fingerprint** (cpu model + effective cores) and a
**scale bucket** (log2 of n or links): a prior learned on an 8-core
bench host never corrects a plan on a 1-core container, and a prior
from a 2^14 toy never corrects a 2^26 build.  Harvesting traces into the
store comes with the port of the tools that do it.

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
