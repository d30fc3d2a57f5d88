"""Memory/disk budgets: measured use + analytic estimates -> refusals.

The paper's whole design is a memory argument — the elimination-tree build
is a graph *reduction* precisely so it fits in small memory — yet nothing
enforced one: an over-large chunk OOMs, a full disk kills a checkpoint
mid-run.  This module is the enforcement point.  Two env-configured
budgets (``SHEEP_MEM_BUDGET``, ``SHEEP_DISK_BUDGET``, human sizes like
``512M``/``2G``) feed one :class:`ResourceGovernor` that every layer which
allocates or writes consults:

  memory   measured RSS (``/proc/self/status`` VmRSS, the same number the
           OOM killer acts on) against the budget, plus ANALYTIC per-chunk
           estimates (links/n/dtype arithmetic below) for allocations that
           have not happened yet — the chunk drivers shrink work
           (jrounds, lifting depth) under pressure and the ladder routes
           around rungs whose estimated peak cannot fit
           (runtime/driver.py: the spill rung is the floor).
  disk     ``statvfs`` free space AND a cap on the bytes sheep's own
           artifacts may occupy under a managed directory (checkpoint /
           supervisor state dirs).  Writers preflight BEFORE writing
           (io/atomic.py), and the checkpoint/state-dir owners run the
           retention GC (resources/gc.py) when the cap trips.

Every refusal is a typed :class:`~sheep_tpu_torch.resources.errors.ResourceError`
raised before bytes land — never a torn artifact, never a published lie.

The estimates are deliberately coarse (they exist to pick a survivable
plan, not to bill by the byte): each one prices the dominant arrays of a
code path from first principles (n, live links, itemsize) and is
documented at its definition.  Overestimating degrades earlier — safe;
underestimating is caught by the measured-RSS backstop at the next
dispatch boundary.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .errors import DiskExhausted, MemoryBudgetExceeded

MEM_BUDGET_ENV = "SHEEP_MEM_BUDGET"
DISK_BUDGET_ENV = "SHEEP_DISK_BUDGET"
SCRATCH_DIR_ENV = "SHEEP_SCRATCH_DIR"
LEG_CORES_ENV = "SHEEP_LEG_CORES"
NATIVE_THREADS_ENV = "SHEEP_NATIVE_THREADS"

#: free space a preflighted write must leave behind (the filesystem needs
#: breathing room for directory blocks, the sidecar, and the journal; a
#: write that would land the disk at 100% is a refusal, not a success)
DISK_SLACK = 1 << 20

#: fraction of the memory budget at which the chunk drivers start
#: shrinking work BEFORE the hard refusal point
MEM_SOFT_FRAC = 0.9

_UNITS = {"": 1, "b": 1,
          "k": 1 << 10, "kb": 1 << 10,
          "m": 1 << 20, "mb": 1 << 20,
          "g": 1 << 30, "gb": 1 << 30,
          "t": 1 << 40, "tb": 1 << 40}


def parse_size(spec: str | None) -> int | None:
    """``"512M"`` -> bytes; ``None``/``""``/``"0"`` -> None (no budget).
    Suffixes are binary (K=1024) and case-insensitive; a bare integer is
    bytes.  Raises ValueError on garbage — a misspelled budget must never
    silently mean "unlimited"."""
    if spec is None:
        return None
    s = spec.strip().lower()
    if s in ("", "0", "none", "unlimited"):
        return None
    num = s.rstrip("kmgtb")
    unit = s[len(num):]
    if unit not in _UNITS:
        raise ValueError(f"unparseable size {spec!r} "
                         f"(want e.g. 512M, 2G, 1048576)")
    try:
        val = float(num)
    except ValueError:
        raise ValueError(f"unparseable size {spec!r} "
                         f"(want e.g. 512M, 2G, 1048576)")
    if val < 0:
        raise ValueError(f"negative size {spec!r}")
    return int(val * _UNITS[unit])


def rss_bytes() -> int:
    """This process's resident set in bytes — VmRSS from
    ``/proc/self/status`` (what the OOM killer counts), with a
    peak-RSS getrusage fallback off Linux (conservative: peak >= current,
    so the fallback can only degrade EARLIER, never OOM later)."""
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def disk_free(path: str) -> int:
    """Bytes available to this process on ``path``'s filesystem."""
    st = os.statvfs(path if os.path.isdir(path)
                    else (os.path.dirname(os.path.abspath(path)) or "."))
    return st.f_bavail * st.f_frsize


def dir_usage(directory: str) -> int:
    """Total bytes of the regular files under ``directory`` — what the
    disk budget is charged against.  Symlinks are not followed (a link
    into a data dir must not bill the budget for the graph itself)."""
    total = 0
    for dirpath, _, names in os.walk(directory):
        for name in names:
            try:
                st = os.lstat(os.path.join(dirpath, name))
            except OSError:
                continue
            total += st.st_size
    return total


# ---------------------------------------------------------------------------
# Analytic allocation estimates.  int32 link arrays dominate every path;
# each estimate prices the dominant terms of its code path and nothing else.
# ---------------------------------------------------------------------------


def _pad_pow2(x: int, lo_cap: int = 1 << 10) -> int:
    p = lo_cap
    while p < x:
        p <<= 1
    return p


def snapshot_nbytes(n: int, links: int) -> int:
    """An uncompressed checkpoint .npz (runtime/snapshot.py): seq + pst
    uint32 [n] each, lo + hi int32 [links] each, plus zip bookkeeping."""
    return 8 * n + 8 * links + 4096


def chunk_tables_nbytes(n: int, levels: int) -> int:
    """The lifting phase's jump tables: ``levels`` int32 [n+1] rows (the
    doubling table is built level by level but all rows are live during
    the descent)."""
    return 4 * (n + 1) * max(1, levels)


def native_thread_tables_nbytes(n: int, threads: int) -> int:
    """Priced resident bytes of the threaded native kernels' per-thread
    partial tables: each EXTRA thread folds its slice into a
    private union-find + parent pair over the full [n] position space —
    8n bytes — and the transient pst/histogram partials ride inside the
    estimate's deliberate coarseness (module docstring: over-pricing
    degrades earlier, which is the safe direction).  T=1 prices zero:
    the serial kernels' state is already in every rung's own term."""
    return 8 * n * max(0, threads - 1)


def rung_peak_nbytes(rung: str, n: int, links: int,
                     workers: int = 1, levels: int = 10,
                     threads: int = 1) -> int:
    """Rough peak resident bytes of one degradation-ladder rung
    (runtime/driver.py) reducing ``links`` live links over ``n``
    positions.  Terms:

      mesh/single  pow2-padded int32 lo/hi (double-buffered across a
                   dispatch: XLA holds input and output live) + the jump
                   tables + the replicated parent/pst/seq vectors.
      host         the numpy floor casts links to int64 (16 bytes/link
                   for lo+hi), plus the int64 union-find array and the
                   uint32 parent/pst.
      stream       the resumable windowed fold: uf/parent/pst
                   uint32 [n] (12n), ONE uint32 window pair at a time
                   (8 * min(links, SPILL_BLOCK)), plus the quantile
                   partition's transient hi copy + per-window boolean
                   mask (~5 bytes/link) — the int32 input table itself
                   is the caller's.  Sits between host (16 bytes/link
                   cast) and spill (which pays a scratch file).
      spill        links live in a memory-mapped scratch file; resident
                   state is the union-find fold's O(n) arrays plus one
                   block of links (SPILL_BLOCK) and the carry (<= n
                   kid->parent pairs).

    ``threads`` > 1 adds the threaded native kernels' per-thread partial
    tables (:func:`native_thread_tables_nbytes`) to the rungs
    that run through the native fold — host, stream, spill — so a
    budget that fits the serial build but not T partial tables vetoes
    the thread count, not the rung.
    """
    pad = _pad_pow2(max(1, links))
    tthreads = native_thread_tables_nbytes(n, threads)
    if rung in ("mesh", "single"):
        return (2 * 4 * pad * 2
                + chunk_tables_nbytes(n, levels)
                + 12 * (n + 1))
    if rung == "host":
        return 16 * links + 8 * n + 8 * n + tthreads
    if rung == "stream":
        return 12 * n + 8 * min(links, SPILL_BLOCK) + 5 * links + tthreads
    if rung == "spill":
        return 8 * SPILL_BLOCK + 16 * n + 8 * n + tthreads
    raise ValueError(f"unknown rung {rung!r}")


#: links per fold block of the spill rung (8 bytes resident each): 4M
#: links = 32MB resident — small against any realistic budget, large
#: enough that the per-block union-find amortizes.
SPILL_BLOCK = 1 << 22


def native_thread_plan(n: int, governor: "ResourceGovernor | None" = None
                       ) -> dict:
    """Resolve the threaded native kernels' thread count —
    the value the driver exports as ``SHEEP_NATIVE_THREADS`` for the
    kernels to read.  The driver reaches this through
    ``sheep_tpu_torch.plan.plan_build``, which records the choice
    as a provenance-carrying Decision; the resolution rules live here.

    Resolution order:

      pinned   an explicit ``SHEEP_NATIVE_THREADS`` is the operator's
               word (A/B arms, the forced-T bench) — never second-
               guessed, reported ``forced``.
      cores    otherwise T starts at the host's EFFECTIVE core count
               (affinity ∩ cgroup quota, utils/envinfo.effective_cores)
               capped by the per-leg cores budget ``SHEEP_LEG_CORES``
               when one is set — a distext leg or supervised worker
               running beside siblings must not oversubscribe the cores
               the supervisor granted it.
      budget   the per-thread partial tables cost
               :func:`native_thread_tables_nbytes` (8n per extra
               thread); T shrinks until they fit the current memory
               headroom — a budget can veto threading entirely.

    Returns ``{"threads", "forced", "cores", "leg_cores",
    "partial_bytes", "reason"}``; ``reason`` names the binding
    constraint so the ``ladder.plan`` trace event can explain the
    choice."""
    forced = os.environ.get(NATIVE_THREADS_ENV, "")
    if forced:
        t = max(1, min(64, int(forced)))
        return {"threads": t, "forced": True, "cores": None,
                "leg_cores": None,
                "partial_bytes": native_thread_tables_nbytes(n, t),
                "reason": (f"pinned by {NATIVE_THREADS_ENV} (the library "
                           f"still clamps to granted cores unless "
                           f"SHEEP_NATIVE_OVERSUB=1)")}
    from ..utils.envinfo import effective_cores
    cores = effective_cores()
    leg_cores = int(os.environ.get(LEG_CORES_ENV, "0") or 0)
    t = min(cores, leg_cores) if leg_cores else cores
    t = max(1, min(64, t))
    reason = (f"leg cores budget ({LEG_CORES_ENV}={leg_cores})"
              if leg_cores and leg_cores < cores
              else f"host effective cores ({cores})")
    gov = governor if governor is not None else ResourceGovernor.from_env()
    head = gov.mem_headroom()
    if head is not None:
        vetoed = t
        while t > 1 and native_thread_tables_nbytes(n, t) > head:
            t -= 1
        if t < vetoed:
            reason = (f"memory budget vetoed {vetoed} -> {t} "
                      f"(partial tables 8n/thread vs headroom)")
    return {"threads": t, "forced": False, "cores": cores,
            "leg_cores": leg_cores or None,
            "partial_bytes": native_thread_tables_nbytes(n, t),
            "reason": reason}


@dataclass
class ResourceGovernor:
    """One process's budget state.  ``None`` budget = unlimited (every
    check passes; pressure is never reported) — the unbudgeted fast path
    costs two attribute reads."""

    mem_budget: int | None = None
    disk_budget: int | None = None
    scratch_dir: str | None = None

    @classmethod
    def from_env(cls, **overrides) -> "ResourceGovernor":
        kw: dict = dict(
            mem_budget=parse_size(os.environ.get(MEM_BUDGET_ENV)),
            disk_budget=parse_size(os.environ.get(DISK_BUDGET_ENV)),
            scratch_dir=os.environ.get(SCRATCH_DIR_ENV) or None,
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def active(self) -> bool:
        return self.mem_budget is not None or self.disk_budget is not None

    # -- memory ------------------------------------------------------------

    def mem_headroom(self) -> int | None:
        """Bytes left under the memory budget (may be negative), or None
        when no budget is set."""
        if self.mem_budget is None:
            return None
        return self.mem_budget - rss_bytes()

    def mem_pressure(self, frac: float = MEM_SOFT_FRAC) -> bool:
        """True once measured RSS crosses ``frac`` of the budget — the
        soft threshold at which chunk drivers shrink work."""
        if self.mem_budget is None:
            return False
        return rss_bytes() > frac * self.mem_budget

    def check_mem(self, need: int, what: str) -> None:
        """Refuse an allocation the analytic model prices over the
        remaining headroom.  No-op without a budget."""
        head = self.mem_headroom()
        if head is not None and need > head:
            raise MemoryBudgetExceeded(
                f"{what}: needs ~{need >> 20}MB but only "
                f"{max(0, head) >> 20}MB of the "
                f"{self.mem_budget >> 20}MB memory budget remains "
                f"(rss {rss_bytes() >> 20}MB)")

    def shrunk_levels(self, levels: int, n: int) -> int:
        """Cap the lifting depth so the jump tables fit the CURRENT
        memory headroom (never below 2 — depth 2 still terminates, just
        slower).  Unbudgeted: unchanged."""
        head = self.mem_headroom()
        if head is None or levels <= 2:
            return levels
        per_level = 4 * (n + 1)
        fit = int(head // (2 * per_level)) if per_level else levels
        return max(2, min(levels, fit))

    # -- disk --------------------------------------------------------------

    def preflight_write(self, path: str, need: int) -> None:
        """Refuse a write of ~``need`` bytes that the target filesystem
        cannot hold with :data:`DISK_SLACK` to spare.  This is the
        universal half of the preflight (io/atomic.py calls it when the
        writer can estimate its size); the budget half lives with the
        managed-directory owners (:meth:`check_dir_budget`)."""
        if need <= 0:
            return
        free = disk_free(path)
        if need + DISK_SLACK > free:
            raise DiskExhausted(
                f"{path}: refusing to write ~{need} bytes with only "
                f"{free} free (slack {DISK_SLACK})")

    def dir_budget_deficit(self, directory: str, need: int) -> int:
        """Bytes the ``SHEEP_DISK_BUDGET`` cap is short for ``need`` more
        bytes under ``directory`` (<= 0 means it fits; 0 when no budget)."""
        if self.disk_budget is None:
            return 0
        return dir_usage(directory) + need - self.disk_budget

    def check_dir_budget(self, directory: str, need: int,
                         what: str) -> None:
        deficit = self.dir_budget_deficit(directory, need)
        if deficit > 0:
            raise DiskExhausted(
                f"{what}: {directory} would exceed the "
                f"{self.disk_budget}-byte disk budget by {deficit} bytes "
                f"(retention GC could not reclaim enough)")
