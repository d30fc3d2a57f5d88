"""The fault-tolerant build driver: checkpointed chunk loops + retry +
the graceful-degradation ladder (port of sheep_tpu/runtime/driver.py).

Failure model.  The chunked architecture already bounds each device
dispatch (ops/forest.py); this module makes the HOST loop around those
dispatches survivable:

  faulted dispatch      retry with exponential backoff, halving the
                        per-dispatch round count (runtime/retry.py) — a
                        dispatch that tripped the per-execution budget
                        asks for half the work next time.
  killed process        every chunk boundary checkpoints the complete
                        build state (runtime/snapshot.py); a new process
                        with ``resume=True`` continues from the last
                        completed chunk and produces the bit-identical
                        tree (forest = f(threshold connectivity) only).
  sick card             the degradation ladder: single-card chunked ->
                        host union-find (host, stream, spill), on an
                        injected fault, a watchdog deadline or memory
                        exhaustion (faults.degradable).  A kernel fault
                        on the card is retried on its rung and then
                        fails the build: it is never finished on the
                        host in the card's place.  Every
                        rung consumes the previous rung's checkpoint,
                        because all rungs reduce the same link multiset
                        over the same sequence — the associativity that
                        powers the reference's tree merge
                        (lib/jnode.cpp:174-201) is exactly what makes
                        partial state transportable across rungs.

On the card.  The ``single`` rung runs the port's hosted reduce loop on
the build's device, so on CUDA every chunk's descent goes through kernel
K1.  Once it has failed, nothing touches the card again: the host rungs
and the driver's tail work on the host ``lo``/``hi`` the driver holds or
on the checkpoint (a sticky CUDA error, such as an illegal address,
poisons every later CUDA call in the process).  A hung kernel cannot be
abandoned on CUDA, so a watchdog timeout on the card gives the rung up
(runtime/faults.py DeviceHung) and recovery is the ``host`` rung.

Determinism: pst is order-free and counted once at prep; the parent array
is the unique elimination forest of the link multiset, so ANY interleaving
of chunks, retries, resumes, and rung handoffs converges to the same
output.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import INVALID_JNID, resolve_device
from ..core.forest import Forest, build_forest_links, edges_to_positions
from ..core.sequence import degree_sequence
from ..integrity.errors import IntegrityError
from ..integrity.sidecar import resolve_policy
from ..obs import trace as obs
from ..plan.model import DEFAULT_LADDER, available_rungs, plan_build
from ..resources.governor import (NATIVE_THREADS_ENV, ResourceGovernor,
                                  rss_bytes)
from .faults import (degradable, fault_point, is_retryable,
                     reset_counters)
from .retry import RetryPolicy, run_with_retry
from .snapshot import Checkpointer, Snapshot, input_signature


@dataclass
class RuntimeConfig:
    """One build's fault-tolerance knobs (env SHEEP_CHECKPOINT_DIR/
    SHEEP_RESUME/SHEEP_MAX_RETRIES and friends, read by
    :meth:`from_env`).

    ``ladder`` keeps the reference's default tuple, but the port runs
    only the rungs it has ported (``_RUNGS``: single, host, stream,
    spill): the planner's ``known=`` filter drops "mesh" (it waits for
    the port of ``parallel/``) and "ext" (it waits for
    ``ops/extmem.py``) wherever a ladder names them."""

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
    #: degradation ladder, tried in order.  "single" is the hosted chunk
    #: loop on the build's device; "host" is the exact native
    #: union-find; "stream" folds the SAME in-RAM link table through the
    #: resumable native union-find one hi-quantile window at a time —
    #: O(n + window) beyond the input, no int64 cast, no scratch file;
    #: "spill", the memory FLOOR, keeps the links table in a
    #: memory-mapped scratch file and folds it in bounded blocks.
    ladder: tuple[str, ...] = ("mesh", "single", "host", "stream", "ext",
                               "spill")
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


class ChunkRuntime:
    """The per-rung context the chunk loop threads its host-sync
    boundaries through (ops/forest.reduce_links_hosted accepts one as
    ``runtime=``).

    ``dispatch`` wraps one device dispatch in the retry/watchdog/fault-
    injection policy; ``boundary`` checkpoints the live link multiset at a
    completed chunk and is itself a fault-injection site ("boundary" —
    the kill point of the resume property test).  ``device`` is the
    build's device, on which the ``single`` rung runs the loop.
    """

    def __init__(self, policy: RetryPolicy, checkpointer: Checkpointer | None,
                 events: list, rung: str, n: int, seq: np.ndarray,
                 pst: np.ndarray, input_sig: str, rounds_base: int = 0,
                 promote_after: int = 0,
                 governor: ResourceGovernor | None = None,
                 device: torch.device | None = None):
        self.policy = policy
        self.ckpt = checkpointer
        self.events = events
        #: resource budgets: None = unbudgeted (every check is a no-op)
        self.governor = governor
        self.device = device if device is not None else torch.device("cpu")
        self._last_levels_cap: int | None = None
        self.rung = rung
        self.n = n
        self.seq = seq
        self.pst = pst
        self.input_sig = input_sig
        self.rounds_base = rounds_base
        #: promotion back to the fast pipelined path: after
        #: ``promote_after`` consecutive retry-free dispatches the FT
        #: wrapper (watchdog thread + per-dispatch sync) is dropped,
        #: letting dispatches queue asynchronously again; the first fault
        #: demotes back and retries under the full policy.  0 disables.
        self.promote_after = promote_after
        self._healthy = 0
        self._promoted = False
        import time
        self._clock = time.perf_counter
        self._last_boundary_t = self._clock()

    def cap_levels(self, levels: int, n: int) -> int:
        """Memory-budget cap on the lifting depth (the jump tables are
        the chunk loop's dominant O(n) allocation): under a configured
        ``SHEEP_MEM_BUDGET`` the depth shrinks so the tables fit the
        CURRENT headroom (governor.shrunk_levels).  Unbudgeted: identity.
        The chunk drivers call this at every lv decision, so the cap
        tracks pressure as the build's resident set grows and shrinks."""
        if self.governor is None:
            return levels
        lv = self.governor.shrunk_levels(levels, n)
        if lv != levels and lv != self._last_levels_cap:
            self._last_levels_cap = lv
            self.events.append(("mem-levels", self.rung, lv))
        return lv

    def dispatch(self, site: str, fn, j: int | None = None):
        """Run dispatch ``fn(j)`` under the retry policy (or, once
        promoted, the bare pipelined path).  Returns (outputs, j_used) —
        ``j_used`` may have shrunk (a retry after a fault, or the memory
        governor trimming chunk size under RSS pressure: a smaller j
        reaches the next compaction/boundary sooner, which is when the
        live set — and the resident set with it — shrinks)."""
        if self.governor is not None and j is not None and j > 1 \
                and self.governor.mem_pressure():
            j = max(1, j // 2)
            self.events.append(("mem-shrink", self.rung, site, j))

        inner = fn

        def fn(jj, _inner=inner, _site=site, _rung=self.rung):
            # flight-recorder span per dispatch attempt (obs/trace.py:
            # the no-op singleton when SHEEP_TRACE is unset)
            with obs.span("dispatch", site=_site, rung=_rung, j=jj):
                return _inner(jj)

        if self._promoted:
            try:
                fault_point(site)
                # no watchdog, no sync: the dispatch queues
                # asynchronously and overlaps the host loop.  An async
                # CUDA fault surfaces at the loop's next sync and fails
                # the build (faults.degradable); a synchronous one
                # demotes right here and retries under the full policy.
                return fn(j), j
            except BaseException as exc:
                if not is_retryable(exc):
                    raise
                self._promoted = False
                self._healthy = 0
                self.events.append(("demote", self.rung, site))

        retried = {"n": 0}

        def on_retry(s, attempt, jj):
            retried["n"] = attempt
            self.events.append(("retry", s, attempt, jj))

        out = run_with_retry(self.policy, site, fn, j, on_retry)
        self._healthy = 0 if retried["n"] else self._healthy + 1
        if self.promote_after and self._healthy >= self.promote_after \
                and not self._promoted:
            self._promoted = True
            self.events.append(("promote", self.rung, site))
        return out

    def boundary(self, rounds: int, links_fn) -> None:
        """One completed chunk boundary.  ``links_fn() -> (lo, hi)`` host
        int32 live links in the ORIGINAL vertex space (called only when
        this boundary is on the checkpoint cadence — it may cost a device
        fetch)."""
        if self.ckpt is None:
            return
        now = self._clock()
        chunk_s = now - self._last_boundary_t
        if self.ckpt.want():
            lo, hi = links_fn()
            self.ckpt.save(Snapshot(
                n=self.n, seq=self.seq, pst=self.pst,
                lo=np.asarray(lo, np.int32), hi=np.asarray(hi, np.int32),
                rounds=self.rounds_base + rounds, boundary=0,
                rung=self.rung, input_sig=self.input_sig))
            self.events.append(("checkpoint", self.rung,
                                self.ckpt.boundary - 1))
            # auto-cadence (SHEEP_CHECKPOINT_EVERY=auto): scale the
            # persistence interval from this boundary's measured snapshot
            # cost vs the compute time since the last boundary
            new = self.ckpt.observe(self._clock() - now, chunk_s)
            if new is not None:
                self.events.append(("cadence", self.rung, new))
        else:
            self.ckpt.skip()
        self._last_boundary_t = self._clock()
        # the deterministic kill point: "died between chunks"
        fault_point("boundary")


# ---------------------------------------------------------------------------
# Ladder rungs.  Contract: (lo, hi int32 live links, n, runtime,
# num_workers) -> parent array; int32 with n marking roots (the single
# rung) or uint32 with INVALID_JNID (host rungs) — both normalized by the
# driver.  All rungs reduce the same link multiset, so any rung may pick
# up any other rung's checkpoint.  Only the single rung touches the
# device; the host rungs take numpy links and never touch CUDA.
# ---------------------------------------------------------------------------


def _rung_single(lo, hi, n, rt, num_workers):
    """The hosted chunk loop on the build's device (on CUDA each chunk's
    descent runs through kernel K1), under ``rt``'s retry policy and
    checkpoint boundaries."""
    from ..ops.forest import parent_from_links, reduce_links_hosted

    dev = rt.device
    flo, fhi, _, _, _ = reduce_links_hosted(
        torch.from_numpy(np.ascontiguousarray(lo, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(hi, np.int32)).to(dev), n,
        runtime=rt)
    return parent_from_links(flo, fhi, n).cpu().numpy()


def _rung_host(lo, hi, n, rt, num_workers):
    # exact native union-find, no device dispatches, cannot fault — but
    # it casts the whole links table to int64 (16 bytes/link), so under a
    # tight memory budget the spill rung below is the real floor.  pst
    # is NOT recounted here — the driver already holds the order-free
    # pst from prep (these links may be chunk-rewritten, so per-link
    # counting would be wrong anyway).
    zero = np.zeros(n, dtype=np.uint32)
    forest = build_forest_links(lo.astype(np.int64), hi.astype(np.int64), n,
                                pst=zero)
    return forest.parent


def _rung_stream(lo, hi, n, rt, num_workers):
    """Streaming windowed fold between host and spill: the
    int32 link table stays in RAM, but instead of the host rung's
    16-bytes-per-link int64 cast it folds through the RESUMABLE native
    union-find one ascending hi-quantile window at a time — the exact
    fold the hybrid's streaming handoff feeds (core.forest.links_fold,
    native.LinksFold) — so the peak
    beyond the input is O(n + window), with no scratch file to pay for.

    Soundness: windows partition the multiset by CONTIGUOUS hi range
    (the shared equal-count quantile rule, host_hi_window_bounds), so
    feeding them in ascending order replays the exact grouped insert the
    monolithic build runs.  pst comes from the driver (these links may
    be chunk-rewritten), so the fold runs with a zero pst like the host
    rung.
    """
    from ..core.forest import host_hi_window_bounds, links_fold
    from ..resources.governor import SPILL_BLOCK

    zero = np.zeros(n, dtype=np.uint32)
    fold = links_fold(n, pst=zero)
    k = len(lo)
    if k:
        w = max(1, -(-k // SPILL_BLOCK))
        bounds = host_hi_window_bounds(hi, w, n) if w > 1 else [0, n]
        w = len(bounds) - 1
        for i in range(w):
            sel = hi >= bounds[i]
            if i + 1 < w:  # the last window keeps the whole tail
                sel &= hi < bounds[i + 1]
            fold.block(lo[sel], hi[sel])
            rt.events.append(("stream-window", i, int(sel.sum())))
    parent, _ = fold.finish()
    return parent


def _rung_spill(lo, hi, n, rt, num_workers):
    """The memory FLOOR of the ladder: the links table spills
    to a memory-mapped int32 scratch file and the exact union-find folds
    over it in bounded blocks — O(n + SPILL_BLOCK) resident, any link
    count.  Blocks arrive through the async prefetcher
    (io/prefetch.BlockPrefetcher), so the scratch read of block k+1
    overlaps the fold of block k instead of serializing in front of it.

    Soundness is the associative-merge property (the reference's
    jnode.cpp:174-201 merge): the forest of (carry-links ∪ next-block) is
    the forest of the union, and a converged forest re-enters the fold as
    its <= n (kid -> parent) links.  pst comes from the driver (order-free
    since prep), so the fold runs with a zero pst like the host rung.

    The scratch file lives under SHEEP_SCRATCH_DIR > the checkpoint dir >
    the system temp dir, and is removed on every exit path — scratch is
    never part of the durable/resumable state (the checkpoint still holds
    the authoritative link multiset).
    """
    import shutil
    import tempfile

    from ..core.forest import forest_links
    from ..io.prefetch import BlockPrefetcher
    from ..resources.governor import SPILL_BLOCK

    gov = rt.governor
    root = (gov.scratch_dir if gov is not None and gov.scratch_dir
            else None) or (rt.ckpt.directory if rt.ckpt is not None
                           else None) or tempfile.gettempdir()
    os.makedirs(root, exist_ok=True)
    k = len(lo)
    if k == 0:
        return np.full(n, INVALID_JNID, dtype=np.uint32)
    scratch = tempfile.mkdtemp(prefix="sheep-spill.", dir=root)
    zero = np.zeros(n, dtype=np.uint32)
    try:
        mlo = np.memmap(os.path.join(scratch, "lo.i32"), dtype=np.int32,
                        mode="w+", shape=(k,))
        mhi = np.memmap(os.path.join(scratch, "hi.i32"), dtype=np.int32,
                        mode="w+", shape=(k,))
        mlo[:] = lo
        mhi[:] = hi
        mlo.flush()
        mhi.flush()

        def scratch_blocks():
            # the memmap slice materializes IN THE PREFETCH THREAD — the
            # actual disk/page-cache read overlaps the consumer's fold
            for a in range(0, k, SPILL_BLOCK):
                b = min(a + SPILL_BLOCK, k)
                yield (np.asarray(mlo[a:b], dtype=np.int64),
                       np.asarray(mhi[a:b], dtype=np.int64))

        carry_lo = np.empty(0, dtype=np.int64)
        carry_hi = np.empty(0, dtype=np.int64)
        forest = None
        with BlockPrefetcher(scratch_blocks()) as pf:
            for i, (blo, bhi) in enumerate(pf):
                fold_lo = np.concatenate([carry_lo, blo])
                fold_hi = np.concatenate([carry_hi, bhi])
                forest = build_forest_links(fold_lo, fold_hi, n, pst=zero)
                carry_lo, carry_hi = forest_links(forest)
                rt.events.append(("spill-block", i, len(carry_lo)))
        return forest.parent
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


#: the rungs the port runs; "mesh" and "ext" wait for their modules
_RUNGS = {"single": _rung_single, "host": _rung_host,
          "stream": _rung_stream, "spill": _rung_spill}


@contextlib.contextmanager
def _native_threads_env(tplan: dict):
    """Export the governor's resolved thread count as
    ``SHEEP_NATIVE_THREADS`` for the duration of one rung attempt (the
    kernels read the env per call), restoring the previous value on any
    exit — one driver call must never re-pin the whole process.  A
    pinned env (``forced``) is the operator's word and is left alone."""
    if tplan["forced"] or (tplan["threads"] <= 1
                           and NATIVE_THREADS_ENV not in os.environ):
        yield
        return
    prev = os.environ.get(NATIVE_THREADS_ENV)
    os.environ[NATIVE_THREADS_ENV] = str(tplan["threads"])
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(NATIVE_THREADS_ENV, None)
        else:
            os.environ[NATIVE_THREADS_ENV] = prev


def _ladder_rungs(config: RuntimeConfig, num_workers,
                  device: torch.device) -> list[str]:
    # availability routes through the planner: the device count is the
    # CUDA card count on CUDA and 1 on the CPU, and ``known`` keeps the
    # rungs the port has not ported (mesh, ext) out of the ladder
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    return available_rungs(config.ladder, devices, num_workers,
                           known=_RUNGS)


def build_graph_resilient(tail, head, num_vertices=None, num_workers=None,
                          seq=None, max_vid=None,
                          config: RuntimeConfig | None = None, device=None):
    """Fault-tolerant build: (seq uint32 [m], Forest over m), the contract
    of the reference's ``runtime.build_graph_resilient``, bit-identical
    to the host oracle.

    ``device``: where the ``single`` rung runs the chunk loop; None means
    CUDA, and raises without it (pass ``device="cpu"`` for the CPU).
    ``config.resume`` continues from the checkpoint in
    ``config.checkpoint_dir`` (written by a previous, killed invocation of
    this function over the same input — verified by signature); without a
    usable checkpoint it falls through to a fresh build.  The result is
    bit-identical either way (module docstring).
    """
    device = resolve_device(device)
    config = config or RuntimeConfig.from_env()
    reset_counters()
    policy = config.policy()
    events = config.events
    gov = config.governor if config.governor is not None \
        else ResourceGovernor.from_env()
    ckpt = Checkpointer(config.checkpoint_dir, config.checkpoint_every,
                        governor=gov) \
        if config.checkpoint_dir else None

    tail = np.asarray(tail)
    head = np.asarray(head)
    seq_h = np.asarray(seq, dtype=np.uint32) if seq is not None \
        else degree_sequence(tail, head)
    n = len(seq_h)
    if n == 0:
        return np.empty(0, np.uint32), Forest(
            np.empty(0, np.uint32), np.empty(0, np.uint32))
    sig = input_signature(n, seq_h, tail, head)

    # Resume REJECTS corrupt snapshots instead of resuming into garbage:
    # strict propagates the typed IntegrityError; repair logs
    # the corruption and restarts fresh — bit-identical output either way
    # a build completes.
    snap = None
    if ckpt is not None and config.resume:
        try:
            snap = ckpt.load(integrity=config.integrity)
            if snap is not None:
                snap.verify(sig)
        except IntegrityError as exc:
            if resolve_policy(config.integrity) != "repair":
                raise
            events.append(("corrupt-checkpoint", "resume", str(exc)))
            snap = None
            ckpt.boundary = 0  # fresh build: boundary indices restart
    rungs = _ladder_rungs(config, num_workers, device)
    if snap is not None:
        pst = snap.pst
        lo, hi = snap.lo, snap.hi
        rounds = snap.rounds
        if snap.rung in rungs:  # restart at the rung that wrote it
            rungs = rungs[rungs.index(snap.rung):]
        events.append(("resume", snap.rung, snap.boundary, rounds))
    else:
        # host prep: exact core semantics (deterministic, rung-neutral).
        # lo of every kept record is a present position < n; hi >= n marks
        # pst-only links (absent endpoint) excluded from the tree links.
        with obs.span("prep", n=n, edges=len(tail)):
            lo64, hi64 = edges_to_positions(tail, head, seq_h, max_vid)
            pst = np.bincount(lo64, minlength=n)[:n].astype(np.uint32)
            tree = hi64 < n
            lo = lo64[tree].astype(np.int32)
            hi = hi64[tree].astype(np.int32)
        rounds = 0

    # One planner for the rungs: rung feasibility and the native thread
    # count (SHEEP_LEG_CORES / affinity / cgroup quota, budget-vetoable
    # at 8n partial tables per extra thread) resolve through plan_build,
    # which folds the governor's analytic prices with any measured priors
    # (SHEEP_PLAN_PRIORS); every knob is an override recorded with its
    # provenance (default | priced | learned | forced).  The resolved
    # thread count is exported as SHEEP_NATIVE_THREADS for the native
    # fold to read — restored after the build so one driver call never
    # re-pins a whole process; an operator pin is never second-guessed.
    plan = plan_build(n, len(lo), rungs=rungs, governor=gov,
                      num_workers=num_workers,
                      ladder_forced=tuple(config.ladder) != DEFAULT_LADDER)
    tplan = plan.native_threads
    events.append(("native-threads", tplan["threads"],
                   "pinned" if tplan["forced"] else tplan["reason"]))

    # Memory-budget ladder planning (via the planner): rungs
    # whose (prior-corrected) priced peak cannot fit the headroom are
    # routed around — degrading up-front beats OOM-ing mid-rung.  The
    # last rung (spill: O(n + block) resident) always survives.
    priced: list[dict] = []
    price_of: dict[str, int] = {}
    if gov.active:
        rungs = plan.rungs
        for cand in plan.candidates:
            entry = {"rung": cand["rung"],
                     "est_bytes": cand["est_bytes"],
                     "verdict": cand["verdict"]}
            if "corrected_bytes" in cand:
                entry["corrected_bytes"] = cand["corrected_bytes"]
                entry["prior"] = cand["prior"]["key"]
            priced.append(entry)
            price_of[cand["rung"]] = cand["est_bytes"]
            if cand["verdict"] == "skip":
                events.append(("mem-skip-rung", cand["rung"],
                               cand.get("corrected_bytes",
                                        cand["est_bytes"])))
    # the rung-decision record: the planned order, each rung's governor price (+ any prior correction)
    # and keep/skip verdict, the measured headroom the verdicts were
    # made against, the threaded-vs-serial pick with the constraint that
    # bound it, and every knob decision with its provenance — the
    # harvestable event the prior store learns from (n/links included)
    obs.event("ladder.plan", rungs=list(rungs), priced=priced,
              headroom_bytes=plan.headroom_bytes if gov.active else None,
              rss_bytes=rss_bytes() if gov.active else None,
              budget_bytes=gov.mem_budget if gov.active else None,
              native_threads=dict(tplan), n=n, links=len(lo),
              decisions=plan.decisions_dict())
    if snap is not None:
        obs.event("rung.resume", rung=snap.rung, boundary=snap.boundary,
                  rounds=rounds)

    parent = None
    for i, rung in enumerate(rungs):
        rt = ChunkRuntime(policy, ckpt, events, rung, n, seq_h, pst, sig,
                          rounds_base=rounds,
                          promote_after=config.promote_after,
                          governor=gov if gov.active else None,
                          device=device)
        if snap is None and i == 0:
            # boundary 0 = "prep complete": a kill during the first chunk
            # resumes without re-running the degree sort / link mapping
            rt.boundary(0, lambda: (lo, hi))
        try:
            with obs.span("rung", rung=rung, links=len(lo)), \
                    _native_threads_env(tplan):
                parent = _RUNGS[rung](lo, hi, n, rt, num_workers)
            obs.event("rung.ok", rung=rung, rss_bytes=rss_bytes(),
                      est_bytes=price_of.get(rung), n=n)
            break
        except Exception as exc:
            # Memory exhaustion, the host's or the card's, an injected
            # fault and a watchdog deadline degrade DOWN the ladder (the
            # cheaper rung is the recovery); disk exhaustion propagates
            # (the next rung would hit the same full disk — the run
            # aborts typed and resumable instead), and so does a kernel
            # fault on the card (faults.degradable).  From here on
            # nothing touches the card: the next rungs take the host
            # links held here or the checkpoint's.
            if not degradable(exc) or i + 1 >= len(rungs):
                raise
            events.append(("degrade", rung, rungs[i + 1],
                           f"{type(exc).__name__}: {exc}"))
            obs.event("rung.degrade", rung=rung, next=rungs[i + 1],
                      why=f"{type(exc).__name__}: {exc}")
            if ckpt is not None:
                # Pick up whatever progress the failed rung checkpointed —
                # but REFUSE a handoff whose checkpoint fails verification
                # (any policy): the in-memory links are known-good, a
                # corrupt snapshot is not, so the next rung just redoes
                # the failed rung's progress.
                try:
                    mid = ckpt.load(integrity=config.integrity)
                    if mid is not None:
                        mid.verify(sig)
                except IntegrityError as exc:
                    events.append(("corrupt-checkpoint", rung, str(exc)))
                    mid = None
                if mid is not None:
                    lo, hi, rounds = mid.lo, mid.hi, mid.rounds
    if parent is None:  # pragma: no cover - host rung cannot fail
        raise RuntimeError("degradation ladder exhausted without a result")

    pa = np.asarray(parent).astype(np.int64)
    out = np.full(n, INVALID_JNID, dtype=np.uint32)
    live = (pa >= 0) & (pa < n)
    out[live] = pa[live].astype(np.uint32)
    forest = Forest(out, pst.astype(np.uint32))
    # Fast-oracle gate: O(n) structural invariants on the result of
    # whatever rung finished.  A rung that "succeeded" with garbage (a
    # bad card) fails HERE, loudly, instead
    # of partitioning a wrong tree.  Links are not re-checked against pst
    # — chunk rounds rewrite the live multiset, only the structure is
    # invariant at this point.
    from ..core.validate import check_forest_fast
    problems = check_forest_fast(forest)
    if problems:
        raise IntegrityError(
            "resilient build produced an invalid forest: "
            + "; ".join(problems))
    if ckpt is not None:
        ckpt.clear()  # build complete: a later --resume starts fresh
    return seq_h, forest
