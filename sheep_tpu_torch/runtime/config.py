"""The fault-tolerant build's configuration (``RuntimeConfig``), kept
apart from the driver so that the CLI reads it without loading torch
(runtime/driver.py re-exports it)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..resources.governor import ResourceGovernor
from .retry import RetryPolicy


@dataclass
class RuntimeConfig:
    """One build's fault-tolerance knobs (env SHEEP_CHECKPOINT_DIR/
    SHEEP_RESUME/SHEEP_MAX_RETRIES and friends, read by
    :meth:`from_env`).

    ``ladder`` keeps the reference's default tuple; the build drops
    "mesh" where fewer than two mesh workers exist and "ext" without a
    whole-input ``.dat``, as the reference's does."""

    checkpoint_dir: str | None = None
    resume: bool = False
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    watchdog_s: float | None = None
    #: checkpoint cadence: persist every k-th boundary; 0 = auto-tune from
    #: measured snapshot cost vs chunk compute time (snapshot.Checkpointer)
    checkpoint_every: int = 1
    #: after this many consecutive healthy (retry-free) dispatches, a rung
    #: is promoted back to the fast pipelined dispatch path — no watchdog
    #: thread, no per-dispatch block_until_ready — and demoted to the FT
    #: wrapper again on the first fault (0 disables promotion)
    promote_after: int = 16
    #: integrity policy for checkpoint loads (strict/repair/trust; None =
    #: env SHEEP_INTEGRITY, default strict).  strict: a corrupt snapshot
    #: aborts the resume with a typed IntegrityError; repair: it is
    #: discarded and the build restarts fresh — never resumed into garbage.
    integrity: str | None = None
    #: degradation ladder, tried in order.  "mesh" is the chunked
    #: sharded reduce over the mesh's workers (skipped when fewer than
    #: two exist); "single" is the hosted chunk loop on the build's
    #: device; "host" is the exact native
    #: union-find; "stream" folds the SAME in-RAM link table through the
    #: resumable native union-find one hi-quantile window at a time —
    #: O(n + window) beyond the input, no int64 cast, no scratch file;
    #: "ext" re-streams the ORIGINAL ``.dat`` file block-wise through
    #: the external-memory build (ops/extmem) — O(n + block) with no link
    #: table resident at all, available only when ``edges_path`` names
    #: the file — so tight budgets pick it before "spill", the memory
    #: FLOOR, which keeps the links table in a memory-mapped scratch file
    #: and folds it in bounded blocks.
    ladder: tuple[str, ...] = ("mesh", "single", "host", "stream", "ext",
                               "spill")
    #: the ``.dat`` file whose FULL record stream is this build's edge
    #: input (None for in-memory or partial-load builds).  This is what
    #: arms the "ext" rung: unlike every other rung, ext ignores the
    #: in-RAM link table and re-streams the original file, which is only
    #: the same build when the file IS the whole input.  SHEEP_EDGES_PATH
    #: sets it for scripts.
    edges_path: str | None = None
    #: resource budgets (SHEEP_MEM_BUDGET / SHEEP_DISK_BUDGET); None =
    #: build one from the environment.  The governor routes the ladder
    #: around rungs whose estimated peak cannot fit, shrinks chunk work
    #: under measured-RSS pressure, and prices checkpoint writes.
    governor: ResourceGovernor | None = None
    #: observable trace of what the runtime did: ("retry", site, attempt,
    #: j), ("checkpoint", rung, boundary), ("degrade", rung, next, why),
    #: ("resume", rung, boundary, rounds).  Tests and chip_smoke.py read
    #: this.
    events: list = field(default_factory=list)

    @classmethod
    def from_env(cls, **overrides) -> "RuntimeConfig":
        env = os.environ
        every_s = env.get("SHEEP_CHECKPOINT_EVERY", "1")
        kw: dict = dict(
            checkpoint_dir=env.get("SHEEP_CHECKPOINT_DIR") or None,
            resume=env.get("SHEEP_RESUME", "") == "1",
            max_retries=int(env.get("SHEEP_MAX_RETRIES", "3")),
            backoff_base_s=float(env.get("SHEEP_BACKOFF_BASE", "0.05")),
            checkpoint_every=0 if every_s == "auto" else int(every_s),
            promote_after=int(env.get("SHEEP_PROMOTE_AFTER", "16")),
            integrity=env.get("SHEEP_INTEGRITY") or None,
            edges_path=env.get("SHEEP_EDGES_PATH") or None,
        )
        if env.get("SHEEP_WATCHDOG_S"):
            kw["watchdog_s"] = float(env["SHEEP_WATCHDOG_S"])
        kw.update(overrides)
        return cls(**kw)

    def policy(self) -> RetryPolicy:
        return RetryPolicy(max_retries=self.max_retries,
                           backoff_base_s=self.backoff_base_s,
                           backoff_cap_s=self.backoff_cap_s,
                           watchdog_s=self.watchdog_s)
