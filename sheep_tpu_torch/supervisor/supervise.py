"""The tournament supervisor: heartbeat-supervised, fsck-gated, resumable
(port of sheep_tpu/supervisor/supervise.py).

The reference's bash tournament (scripts/horizontal-dist.sh) is
fire-and-forget — one dead, hung, or corrupted worker forces a full
re-run.  The supervisor owns the
sort -> map -> merge-tournament lifecycle end to end and survives any
single-point failure:

  worker dies       the attempt's exit status (or vanished process) fails
                    the leg; it is re-dispatched with the
                    retry/backoff policy (runtime/retry.RetryPolicy).
  worker hangs      every attempt owns a heartbeat file
                    (supervisor/heartbeat.py); a beat stale past the
                    deadline declares the attempt dead and the leg is
                    re-dispatched.  A straggler that still beats can be
                    speculatively re-executed (``speculate_after_s``):
                    first finisher publishes, the loser's artifact is
                    discarded (sig-checked, never merged).
  artifact corrupt  every attempt writes to a private temp name; the
                    supervisor fscks the temp artifact (sidecar checksum
                    + structural checks, integrity/fsck.py) and checks
                    its input signature against the manifest BEFORE the
                    atomic publish — a bad artifact is a failed attempt,
                    never a tournament input.
  supervisor dies   all durable state lives in the checksummed manifest
                    (supervisor/manifest.py), rewritten atomically after
                    every dispatch and publish.  A new supervisor resumes
                    by fsck-ing the artifacts the manifest claims done
                    and re-dispatching ONLY the dirty/missing legs — a
                    clean ``NNr0.tre`` is never re-mapped.

Publish protocol (the reference's scripts/lib.sh sheep_mv_artifact order):
sidecar first, artifact second, both via atomic rename — a consumer that
sees an artifact under its final name also sees its matching checksum.

Everything above is property-tested by deterministic chaos
(supervisor/chaos.py, ``SHEEP_FAULT_PLAN``): a kill, corrupt, or hang
injected at EVERY tournament round must yield a final tree bit-identical
to the fault-free run, re-dispatching only the faulted leg.

Every leg the runners start is the PORT's tool (``python -m
sheep_tpu_torch.cli.<tool>``, :data:`CLI_PACKAGE`), and every one of
them — and the supervisor itself — is a host process that never loads
torch: each leg is priced against its own ``SHEEP_MEM_BUDGET`` by its
live RSS.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from ..integrity.errors import IntegrityError
from ..integrity.sidecar import read_sidecar, resolve_policy
from ..resources import ResourceGovernor, gc_orphan_temps, retention_gc
from ..runtime.retry import RetryPolicy
from .chaos import ChaosPlan, SupervisorKilled, plan_from_env
from .heartbeat import (HEARTBEAT_FILE_ENV, HEARTBEAT_INTERVAL_ENV,
                        HeartbeatWriter, beat, is_stale)
from .manifest import (DONE, PENDING, Leg, Manifest, load_manifest,
                       manifest_path, plan_tournament, save_manifest)

#: the package whose tools the runners start, by module name: the port's
#: own, never the reference's
CLI_PACKAGE = "sheep_tpu_torch.cli"


class SupervisionFailed(RuntimeError):
    """The tournament cannot make progress (a leg exhausted its dispatch
    budget, or an input can never appear).  The manifest stays on disk —
    the condition may be transient (full disk, sick node) and a later
    ``sheep supervise`` of the same state dir resumes where this one
    stopped."""


@dataclass
class SupervisorConfig:
    """One supervised tournament's knobs (env: SHEEP_WORKERS / REDUCTION /
    SHEEP_DEADLINE_S / SHEEP_HEARTBEAT_S / SHEEP_SPECULATE_S /
    SHEEP_MAX_RETRIES / SHEEP_BACKOFF_BASE / SHEEP_INTEGRITY /
    SHEEP_FAULT_PLAN)."""

    workers: int = 2
    reduction: int = 2
    #: a worker whose heartbeat is older than this is dead
    deadline_s: float = 30.0
    #: deterministic staleness: when > 0, a silent
    #: worker is declared dead after this many CONSECUTIVE supervisor
    #: polls observed its heartbeat mtime unchanged, instead of by the
    #: wall-clock deadline.  Wall-clock staleness races the scheduler: a
    #: loaded 1-core host can stall a healthy worker's beat past a short
    #: deadline and double-dispatch it (the distext chaos sweep's
    #: 1-in-3 flake).  Poll counting is robust to exactly that — when
    #: the whole process stalls, the supervisor's polls stall with the
    #: beats, so no poll observes a silent interval that never happened.
    stale_after_polls: int = 0
    #: how often workers beat (exported to subprocess workers)
    heartbeat_s: float = 1.0
    #: age at which a still-beating attempt gets a speculative twin
    #: (None = speculation off)
    speculate_after_s: float | None = None
    #: remote build workers: (host, port) list the distext
    #: job may ship hist/distmap legs to (env SHEEP_WORKER_ADDRS);
    #: empty = single-host dispatch only
    worker_addrs: list = field(default_factory=list)
    #: wire heartbeat interval for remote legs (BEAT frames;
    #: env SHEEP_WORKER_BEAT_S)
    worker_beat_s: float = 1.0
    #: wire-beat SILENCE age at which a remote leg gets a speculative
    #: twin on another worker (env SHEEP_WORKER_SPECULATE_S; None = only
    #: the generic speculate_after_s straggler rule applies).  Keyed on
    #: the last beat, not the launch: a worker that streams BEATs for an
    #: hour then goes mute is the failure shape this knob names.
    worker_speculate_s: float | None = None
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    poll_s: float = 0.05
    #: max concurrent attempts (0 = unthrottled; the bash driver's CORES)
    cores: int = 0
    #: CPU cores each leg may use (env SHEEP_LEG_CORES; 0 = unmanaged).
    #: Caps concurrency at host_cores // leg_cores — so a speculative
    #: twin can never oversubscribe the host it shares with the straggler
    #: it is racing — and the subprocess runner pins each attempt to its
    #: own rotating core slice + thread-count env caps.
    leg_cores: int = 0
    #: disk/memory budgets (SHEEP_DISK_BUDGET / SHEEP_MEM_BUDGET); None =
    #: from env.  Under a disk budget the supervisor GCs retired
    #: intermediates (outputs no pending leg consumes — everything it
    #: deletes is re-creatable by a resume) when the state dir trips the
    #: cap, and sweeps write debris on every failure.
    governor: ResourceGovernor | None = None
    integrity: str | None = None
    #: print the reference phase grammar ("Mapped in N seconds.") that
    #: data/make-parallel.sh greps
    grammar: bool = True
    chaos: ChaosPlan | None = None
    # injectable for tests
    sleep: Callable[[float], None] = field(default=time.sleep)
    #: observable trace: ("dispatch", key, n), ("publish", key),
    #: ("leg-failed", key, reason), ("stale", key), ("speculate", key),
    #: ("discard", key, why), ("resume", clean, dirty), ("complete",)
    events: list = field(default_factory=list)

    @classmethod
    def from_env(cls, **overrides) -> "SupervisorConfig":
        env = os.environ
        kw: dict = dict(
            workers=int(env.get("SHEEP_WORKERS", "2") or 2),
            reduction=int(env.get("REDUCTION", "2") or 2),
            deadline_s=float(env.get("SHEEP_DEADLINE_S", "30")),
            stale_after_polls=int(env.get("SHEEP_STALE_POLLS", "0") or 0),
            heartbeat_s=float(env.get("SHEEP_HEARTBEAT_S", "1")),
            max_retries=int(env.get("SHEEP_MAX_RETRIES", "3")),
            backoff_base_s=float(env.get("SHEEP_BACKOFF_BASE", "0.05")),
            leg_cores=int(env.get("SHEEP_LEG_CORES", "0") or 0),
            governor=ResourceGovernor.from_env(),
            integrity=env.get("SHEEP_INTEGRITY") or None,
            chaos=plan_from_env(),
        )
        if env.get("SHEEP_SPECULATE_S"):
            kw["speculate_after_s"] = float(env["SHEEP_SPECULATE_S"])
        if env.get("SHEEP_WORKER_ADDRS"):
            from ..serve.worker import parse_worker_addrs
            kw["worker_addrs"] = parse_worker_addrs(
                env["SHEEP_WORKER_ADDRS"])
        kw["worker_beat_s"] = float(env.get("SHEEP_WORKER_BEAT_S", "1")
                                    or 1)
        if env.get("SHEEP_WORKER_SPECULATE_S"):
            kw["worker_speculate_s"] = \
                float(env["SHEEP_WORKER_SPECULATE_S"])
        kw.update(overrides)
        return cls(**kw)

    @property
    def max_dispatches(self) -> int:
        return self.max_retries + 1

    def policy(self) -> RetryPolicy:
        return RetryPolicy(max_retries=self.max_retries,
                           backoff_base_s=self.backoff_base_s,
                           backoff_cap_s=self.backoff_cap_s)


# ---------------------------------------------------------------------------
# Attempt handles + runners.  A runner turns a leg's argv into a running
# attempt; the supervisor only ever sees the handle (poll / cancel), so
# the inline (thread) and subprocess runners — and the chaos fakes — are
# interchangeable and the recovery logic cannot fork between them.
# ---------------------------------------------------------------------------


class _ThreadHandle:
    """An attempt running on a thread (inline runner + internal copies)."""

    def __init__(self, target: Callable[[], int]):
        self._rc: int | None = None
        self._done = threading.Event()

        def run():
            try:
                self._rc = int(target() or 0)
            except BaseException:  # the supervisor retries; never crashes
                self._rc = 1
            finally:
                self._done.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def poll(self) -> int | None:
        return self._rc if self._done.is_set() else None

    def cancel(self) -> None:
        # threads cannot be interrupted; the attempt is abandoned (daemon)
        # and its temp output ignored — exactly how a real orphan behaves
        pass


class _DeadHandle:
    """Chaos "kill": the worker died immediately (rc 137)."""

    def poll(self) -> int | None:
        return 137

    def cancel(self) -> None:
        pass


class _HangHandle:
    """Chaos "hang": the worker never completes and never beats again."""

    def poll(self) -> int | None:
        return None

    def cancel(self) -> None:
        pass


class _SubprocessHandle:
    def __init__(self, proc, log_f):
        self._proc = proc
        self._log_f = log_f

    def poll(self) -> int | None:
        rc = self._proc.poll()
        if rc is not None and self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        return rc

    def cancel(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            try:
                self._proc.wait(timeout=10)
            except Exception:
                pass
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None


class InlineRunner:
    """Run legs in-process on threads — the fast path for tests and the
    chaos smoke (no interpreter start-up per leg).  Workers heartbeat via
    a HeartbeatWriter wrapped around the CLI main."""

    def __init__(self, interval_s: float = 0.1):
        self.interval_s = interval_s

    def start(self, argv: list[str], hb_path: str, log_path: str):
        import importlib

        def target() -> int:
            hb = HeartbeatWriter(hb_path, self.interval_s).start()
            try:
                mod = importlib.import_module(f"{CLI_PACKAGE}.{argv[0]}")
                return int(mod.main(argv[1:]) or 0)
            except SystemExit as exc:
                return int(exc.code or 0)
            except BaseException as exc:
                try:
                    with open(log_path, "a") as f:
                        f.write(f"{type(exc).__name__}: {exc}\n")
                except OSError:
                    pass
                return 1
            finally:
                hb.stop()

        return _ThreadHandle(target)


class SubprocessRunner:
    """Run legs as real CLI subprocesses — the production path.  Each
    child gets SHEEP_HEARTBEAT_FILE pointing at its attempt's heartbeat
    (cli/common.maybe_start_heartbeat) and logs to the state dir.

    ``leg_cores`` (env SHEEP_LEG_CORES): pin each child to its own
    rotating ``leg_cores``-wide slice of the host's affinity mask and cap
    its math-library thread counts to match — the per-leg cores budget
    that keeps a speculative twin from oversubscribing the host it
    shares with the straggler it is racing (the supervisor separately
    caps CONCURRENCY at host_cores // leg_cores)."""

    _THREAD_ENVS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS")

    def __init__(self, interval_s: float = 1.0, env: dict | None = None,
                 leg_cores: int = 0):
        self.interval_s = interval_s
        self.env = env
        self.leg_cores = leg_cores
        self._slot = 0

    def _pin(self, env: dict):
        """(preexec_fn, env) for the next attempt's core slice; (None,
        env) when unmanaged or the platform lacks affinity control."""
        k = self.leg_cores
        if not k or not hasattr(os, "sched_setaffinity"):
            return None, env
        try:
            host = sorted(os.sched_getaffinity(0))
        except OSError:
            host = list(range(os.cpu_count() or 1))
        slots = max(1, len(host) // k)
        at = (self._slot % slots) * k
        self._slot += 1
        cpus = set(host[at: at + k]) or set(host)
        for var in self._THREAD_ENVS:
            env[var] = str(k)

        def preexec():  # runs in the child, pre-exec
            try:
                os.sched_setaffinity(0, cpus)
            except OSError:
                pass
        return preexec, env

    def start(self, argv: list[str], hb_path: str, log_path: str):
        import subprocess

        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(self.env if self.env is not None else os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env[HEARTBEAT_FILE_ENV] = hb_path
        env[HEARTBEAT_INTERVAL_ENV] = str(self.interval_s)
        preexec, env = self._pin(env)
        log_f = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{CLI_PACKAGE}.{argv[0]}"] + argv[1:],
            stdout=log_f, stderr=subprocess.STDOUT, env=env,
            preexec_fn=preexec)
        return _SubprocessHandle(proc, log_f)


@dataclass
class _Attempt:
    leg: Leg
    number: int          # this leg's dispatch ordinal (1-based)
    tmp: str
    hb: str
    handle: object
    started: float
    corrupt_on_success: bool = False
    cancelled: bool = False
    # poll-count staleness state (SupervisorConfig.stale_after_polls):
    # the last observed beat mtime and how many consecutive polls saw it
    # unchanged
    hb_mtime: float | None = None
    quiet_polls: int = 0


# ---------------------------------------------------------------------------
# Validation + publish
# ---------------------------------------------------------------------------


def _artifact_checker(final_path: str):
    from ..integrity.fsck import _CHECKERS
    for suffix, checker in _CHECKERS.items():
        if final_path.endswith(suffix):
            return checker
    raise SupervisionFailed(f"{final_path}: not a checkable artifact class")


def _validate_artifact(tmp: str, final_path: str, mode: str) -> str | None:
    """fsck the temp artifact as its final class would be checked; returns
    the sidecar's input signature (if any).  Raises IntegrityError."""
    _artifact_checker(final_path)(tmp, mode)
    sc = read_sidecar(tmp) if mode != "trust" else None
    return sc.get("sig") if sc else None


def _discard(*paths: str) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


#: attempt-private files: <output>.aN plus its .sum / .hb companions
_ATTEMPT_DEBRIS_RE = re.compile(r"\.a\d+(\.sum|\.hb)?$")


def sweep_attempt_debris(state_dir: str) -> list[str]:
    """Remove the attempt temps a DEAD supervisor stranded.
    Only safe when no attempts are in flight — run_supervised calls it
    before constructing the supervisor.  Attempt files are by protocol
    unpublished (the publish is the rename away from the ``.aN`` name),
    so a resume never reads one; left behind they only eat the budget."""
    removed = []
    try:
        names = os.listdir(state_dir)
    except OSError:
        return removed
    for name in names:
        if _ATTEMPT_DEBRIS_RE.search(name):
            path = os.path.join(state_dir, name)
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
    return removed


def _corrupt_bytes(path: str) -> None:
    """Chaos "corrupt": flip one payload byte under the unchanged sidecar
    (bit rot after a successful write — exactly what fsck exists for)."""
    with open(path, "r+b") as f:
        f.seek(5 if os.path.getsize(path) > 5 else 0)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# The supervisor proper
# ---------------------------------------------------------------------------


class TournamentSupervisor:
    def __init__(self, manifest: Manifest, state_dir: str,
                 config: SupervisorConfig, runner=None):
        self.manifest = manifest
        self.state_dir = state_dir
        self.config = config
        self.runner = runner if runner is not None \
            else SubprocessRunner(interval_s=config.heartbeat_s,
                                  leg_cores=config.leg_cores)
        self.policy = config.policy()
        self.governor = config.governor if config.governor is not None \
            else ResourceGovernor.from_env()
        self.mode = resolve_policy(config.integrity)
        self.events = config.events
        self.log_dir = os.path.join(state_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._running: dict[str, list[_Attempt]] = {}
        self._backoff_until: dict[str, float] = {}
        #: artifact path -> the leg that produces it; a consumer is ready
        #: only when its producers are DONE, not merely when bytes exist
        #: under the input name (a resume may have marked the producer
        #: dirty while its corrupt artifact still sits on disk)
        self._producer: dict[str, Leg] = {
            leg.output: leg for leg in manifest.legs}
        #: dispatches this supervisor LIFE launched per leg — the retry
        #: budget is per-life so a many-times-resumed run is never
        #: permanently bricked by its history
        self._life: dict[str, int] = {}

    # -- resource budgets --------------------------------------------------

    def _slots(self) -> int:
        """Max concurrent attempts: the explicit ``cores`` throttle
        AND the per-leg cores budget (host_cores // leg_cores) — the
        tighter wins; 0 = unthrottled."""
        slots = self.config.cores
        if self.config.leg_cores:
            try:
                avail = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                avail = os.cpu_count() or 1
            by_budget = max(1, avail // self.config.leg_cores)
            slots = min(slots, by_budget) if slots else by_budget
        return slots

    def _inflight(self) -> int:
        return sum(len(a) for a in self._running.values())

    def _maybe_gc(self, force: bool = False) -> int:
        """Reclaim retired intermediates when the state dir trips the
        ``SHEEP_DISK_BUDGET`` cap (or on ``force``: an attempt just
        failed with what may be a full disk).  Keep-resumable: the
        manifest, the final tree, the sequence, every pending leg's
        inputs/output, and all in-flight attempt files are protected;
        everything deleted is re-creatable by a resume (reconcile marks
        the producers of a missing-but-needed artifact pending again)."""
        gov = self.governor
        if gov.disk_budget is None and not force:
            return 0
        deficit = gov.dir_budget_deficit(self.state_dir, 0)
        if deficit <= 0 and not force:
            return 0
        protect = {manifest_path(self.state_dir),
                   self.manifest.final_tree, self.manifest.seq_file}
        for leg in self.manifest.legs:
            if leg.state != DONE:
                protect.add(leg.output)
                protect.update(leg.inputs)
        for atts in self._running.values():
            for att in atts:
                protect.update((att.tmp, att.hb))
        freed, removed = retention_gc(self.state_dir, protect=protect,
                                      keep_last=0, need=max(0, deficit),
                                      live_bases=self._live_temp_bases())
        if removed:
            self.events.append(("gc", len(removed), freed))
        return freed

    # -- dispatch ----------------------------------------------------------

    def _leg_argv(self, leg: Leg) -> list[str]:
        m = self.manifest
        if leg.kind == "sort":
            return ["degree_sequence", m.graph, "@OUT@"]
        if leg.kind == "map":
            return ["graph2tree", m.graph,
                    "-l", f"{leg.index + 1}/{m.workers}",
                    "-s", m.seq_file, "-o", "@OUT@"]
        if leg.kind == "hist":
            # distext pass 1: this shard's degree histogram
            a, b = m.shards[leg.index]
            return ["distext", "hist", m.graph, "-r", f"{a}:{b}",
                    "-o", "@OUT@"]
        if leg.kind == "distmap":
            # distext pass 2: the ext carry fold over this shard, under
            # the leg's own budget, checkpointing at block boundaries in
            # a per-leg dir (the slice is folded into the checkpoint
            # identity, so a re-dispatch resumes — and a foreign shard
            # map is refused); the leg self-reports perf + proc_status
            from ..ops.distext import leg_checkpoint_dir, leg_perf_path
            a, b = m.shards[leg.index]
            return ["distext", "map", m.graph, "-r", f"{a}:{b}",
                    "-s", m.seq_file, "-o", "@OUT@",
                    "--checkpoint-dir",
                    leg_checkpoint_dir(self.state_dir, leg.key),
                    "--resume",
                    "--perf-out", leg_perf_path(self.state_dir, leg.key)]
        if leg.kind == "merge":
            argv = ["merge_trees"] + list(leg.inputs) + ["-o", "@OUT@"]
            if m.sig:
                argv += ["--expect-sig", m.sig]
            return argv
        raise SupervisionFailed(f"{leg.key}: unknown leg kind {leg.kind!r}")

    def _start_copy(self, leg: Leg, tmp: str, hb_path: str):
        src = leg.inputs[0]

        def target() -> int:
            beat(hb_path)
            if os.path.exists(src + ".sum"):
                shutil.copyfile(src + ".sum", tmp + ".sum")
            shutil.copyfile(src, tmp)
            return 0

        return _ThreadHandle(target)

    def _start_histsum(self, leg: Leg, tmp: str, hb_path: str):
        """The distext Allreduce, serviced by the supervisor
        itself like a copy leg: sum the published per-range histograms
        (integer adds commute — the result is the whole-file histogram
        bit for bit), counting-sort it, and publish the shared sequence
        every pass-2 leg builds over.  A stale histogram from a foreign
        shard map is a failed attempt here (merge_histograms checks each
        input against the manifest's shard map), never a wrong sequence.
        """
        inputs = list(leg.inputs)
        shards = self.manifest.shards
        integrity = self.config.integrity

        def target() -> int:
            from ..obs import trace as obs
            beat(hb_path)
            with obs.span("distext.hist_merge", legs=len(inputs)):
                from ..core.sequence import degree_sequence_from_degrees
                from ..io.seqfile import write_sequence
                from ..ops.distext import merge_histograms, read_histogram
                hists = [read_histogram(p, integrity=integrity)
                         for p in inputs]
                deg = merge_histograms(hists, expect_shards=shards)
                write_sequence(degree_sequence_from_degrees(deg), tmp)
            return 0

        return _ThreadHandle(target)

    def _launch(self, leg: Leg, now: float, speculative: bool = False):
        leg.dispatches += 1
        self._life[leg.key] = self._life.get(leg.key, 0) + 1
        n = leg.dispatches
        tmp = f"{leg.output}.a{n}"
        hb = tmp + ".hb"
        log = os.path.join(self.log_dir, f"{leg.key}.a{n}.log")
        _discard(tmp, tmp + ".sum", hb)

        fault = None
        if self.config.chaos is not None and not speculative:
            fault = self.config.chaos.take_dispatch(leg.round, leg.index)
        if fault == "kill":
            # died mid-write: a torn, sidecar-less partial at the temp name
            with open(tmp, "wb") as f:
                f.write(b"\x00" * 3)
            handle = _DeadHandle()
        elif fault == "hang":
            beat(hb)  # one beat at launch, then silence forever
            handle = _HangHandle()
        elif leg.kind == "copy":
            handle = self._start_copy(leg, tmp, hb)
        elif leg.kind == "histsum":
            handle = self._start_histsum(leg, tmp, hb)
        else:
            argv = [a.replace("@OUT@", tmp) for a in self._leg_argv(leg)]
            handle = self.runner.start(argv, hb, log)
        att = _Attempt(leg=leg, number=n, tmp=tmp, hb=hb, handle=handle,
                       started=now, corrupt_on_success=(fault == "corrupt"))
        self._running.setdefault(leg.key, []).append(att)
        self.events.append(("dispatch", leg.key, n)
                           if not speculative else ("speculate", leg.key, n))
        from ..obs import trace as obs
        obs.event("supervise.dispatch", key=leg.key, kind=leg.kind,
                  round=leg.round, attempt=n, speculative=speculative)
        save_manifest(self.manifest, self.state_dir)

    # -- completion --------------------------------------------------------

    def _publish(self, att: _Attempt) -> None:
        leg = att.leg
        if os.path.exists(att.tmp + ".sum"):
            os.replace(att.tmp + ".sum", leg.output + ".sum")
        os.replace(att.tmp, leg.output)
        _discard(att.hb)
        leg.state = DONE
        self.events.append(("publish", leg.key))
        from ..obs import trace as obs
        obs.event("supervise.publish", key=leg.key, kind=leg.kind,
                  round=leg.round)
        save_manifest(self.manifest, self.state_dir)
        self._maybe_gc()
        # siblings (speculative twins) lost the race: cancel + discard
        for other in self._running.get(leg.key, []):
            if other is not att:
                other.cancelled = True
                other.handle.cancel()
                _discard(other.tmp, other.tmp + ".sum", other.hb)
                self.events.append(("discard", leg.key, "lost-race"))
        self._running.pop(leg.key, None)

    def _complete(self, att: _Attempt) -> None:
        leg = att.leg
        if leg.state == DONE:
            # a speculative loser finishing after the publish
            _discard(att.tmp, att.tmp + ".sum", att.hb)
            self.events.append(("discard", leg.key, "lost-race"))
            return
        if att.corrupt_on_success:
            _corrupt_bytes(att.tmp)
        try:
            sig = _validate_artifact(att.tmp, leg.output, self.mode)
        except (IntegrityError, OSError) as exc:
            self._failed(att, f"fsck: {exc}")
            return
        if leg.output.endswith(".tre") and sig:
            if self.manifest.sig is None:
                self.manifest.sig = sig
            elif sig != self.manifest.sig:
                # an artifact from a DIFFERENT build (stale file, foreign
                # speculation loser): never merged, always a failed attempt
                self._failed(att, f"sig {sig[:12]}... != manifest "
                                  f"{self.manifest.sig[:12]}...")
                return
        self._publish(att)

    def _live_temp_bases(self) -> set[str]:
        """Final basenames of every still-running attempt's output (and
        its sidecar), plus its side-channel files (the distext leg's
        ``--perf-out`` self-report lands in the state dir root too):
        their atomic-write dot-temps are live rename sources a mid-run
        sweep must not reclaim (resources/gc.py is_live_temp — the
        InlineRunner runs sibling legs in THIS process, so a sweep after
        one leg's fault races their writes; a reclaimed perf temp failed
        the healthy sibling's os.replace and double-dispatched it —
        the reference's distext chaos sweep's 1-in-3 flake)."""
        out: set[str] = set()
        for atts in self._running.values():
            for a in atts:
                base = os.path.basename(a.tmp)
                out.add(base)
                out.add(base + ".sum")
                # the leg's perf self-report (ops/distext.leg_perf_path)
                out.add(f"{a.leg.key}.perf.json")
        return out

    def _failed(self, att: _Attempt, reason: str) -> None:
        leg = att.leg
        _discard(att.tmp, att.tmp + ".sum", att.hb)
        self.events.append(("leg-failed", leg.key, reason))
        # an attempt that died on a full disk leaves the condition in
        # place for its retry: sweep write debris, and reclaim retired
        # intermediates (all re-creatable) before dispatching again —
        # sparing the dot-temps sibling attempts are writing RIGHT NOW
        gc_orphan_temps(self.state_dir,
                        live_bases=self._live_temp_bases())
        if "ENOSPC" in reason or "No space" in reason:
            self._maybe_gc(force=True)
        self._running[leg.key] = [
            a for a in self._running.get(leg.key, []) if a is not att]
        if self._running[leg.key]:
            return  # a twin is still in flight; it may still win
        self._running.pop(leg.key, None)
        life = self._life.get(leg.key, 0)
        if life >= self.config.max_dispatches:
            raise SupervisionFailed(
                f"{leg.key}: {life} dispatch(es) failed this run "
                f"(last: {reason}) — budget {self.config.max_dispatches} "
                f"spent; state kept in {self.state_dir} for a later resume")
        self._backoff_until[leg.key] = \
            time.time() + self.policy.backoff(life - 1)

    # -- the loop ----------------------------------------------------------

    def _poll_attempts(self, now: float) -> None:
        for key in list(self._running):
            for att in list(self._running.get(key, [])):
                if att.cancelled:
                    continue
                rc = att.handle.poll()
                if rc is None:
                    if self._attempt_stale(att, now):
                        att.cancelled = True
                        att.handle.cancel()
                        self.events.append(("stale", key, att.number))
                        self._failed(att, "heartbeat deadline exceeded")
                    elif self._should_speculate(att, key, now):
                        self._launch(att.leg, now, speculative=True)
                elif rc == 0:
                    self._complete(att)
                else:
                    self._failed(att, f"exit status {rc}")
                if att.leg.state == DONE and self.config.chaos is not None \
                        and self.config.chaos.take_stop(att.leg.round,
                                                        att.leg.index):
                    self._die(att.leg)

    def _should_speculate(self, att: _Attempt, key: str,
                          now: float) -> bool:
        """Launch a speculative twin for this still-running attempt?
        Two triggers share the guards: the generic straggler rule
        (``speculate_after_s`` since launch) and, for REMOTE attempts,
        the silent-worker rule (``worker_speculate_s`` since the last
        wire beat — a worker that beats for an hour then goes mute gets
        its twin without waiting out the whole straggler age)."""
        if (len(self._running.get(key, [])) != 1
                or self._life.get(key, 0) >= self.config.max_dispatches
                # the cores budget binds speculation too: a twin that
                # would oversubscribe the host only slows the straggler
                # it is meant to beat
                or (self._slots()
                    and self._inflight() >= self._slots())):
            return False
        s = self.config.speculate_after_s
        if s is not None and now - att.started > s:
            return True
        ws = self.config.worker_speculate_s
        if ws is not None and getattr(att.handle, "remote", False):
            from .heartbeat import last_beat_s
            return now - last_beat_s(att.hb, att.started) > ws
        return False

    def _attempt_stale(self, att: _Attempt, now: float) -> bool:
        """Is this still-running attempt dead-by-silence?  Default: the
        wall-clock heartbeat deadline (is_stale).  With
        ``stale_after_polls`` set, staleness is counted in SUPERVISOR
        POLLS that observed the beat mtime unchanged — deterministic
        under whole-process stalls (config field doc), which is what the
        chaos sweeps need to assert exact dispatch counts."""
        polls = self.config.stale_after_polls
        if not polls:
            return is_stale(att.hb, att.started,
                            self.config.deadline_s, now)
        from .heartbeat import last_beat_s
        m = last_beat_s(att.hb, att.started)
        if att.hb_mtime is not None and m <= att.hb_mtime:
            att.quiet_polls += 1
        else:
            att.hb_mtime = m
            att.quiet_polls = 0
        return att.quiet_polls >= polls

    def _die(self, leg: Leg) -> None:
        """Chaos "stop": this supervisor is dead.  Real death would orphan
        the children; the simulation cancels them so tests do not leak."""
        for atts in self._running.values():
            for att in atts:
                att.handle.cancel()
        self.events.append(("supervisor-killed", leg.key))
        raise SupervisorKilled(
            f"injected supervisor death after {leg.key} published")

    def _launch_ready(self, now: float) -> int:
        launched = 0
        slots = self._slots()
        for leg in sorted(self.manifest.pending(),
                          key=lambda l: (l.round, l.index)):
            if leg.key in self._running:
                continue
            if self._backoff_until.get(leg.key, 0) > now:
                continue
            if not all(os.path.exists(p) for p in leg.inputs):
                continue
            if any(p in self._producer and self._producer[p].state != DONE
                   for p in leg.inputs):
                continue
            if slots and self._inflight() >= slots:
                break
            self._launch(leg, now)
            launched += 1
        return launched

    def run(self) -> Manifest:
        cfg = self.config
        t0 = time.time()
        phase_done = {-1: False, 0: False}
        while not self.manifest.done():
            now = time.time()
            launched = self._launch_ready(now)
            self._poll_attempts(now)
            if cfg.grammar:
                self._phase_grammar(phase_done, t0)
            if not self._running and not launched \
                    and not self.manifest.done():
                future = [t for t in self._backoff_until.values() if t > now]
                if not future and not self._launch_ready(time.time()):
                    missing = sorted({
                        p for leg in self.manifest.pending()
                        for p in leg.inputs if not os.path.exists(p)})
                    raise SupervisionFailed(
                        "tournament cannot make progress — missing "
                        "inputs with no producer: " + ", ".join(missing))
            cfg.sleep(cfg.poll_s)
        if cfg.grammar:
            self._phase_grammar(phase_done, t0)
            print(f"Reduced in {time.time() - t0:.8f} seconds.", flush=True)
        self.events.append(("complete",))
        return self.manifest

    def _phase_grammar(self, phase_done: dict, t0: float) -> None:
        """The reference phase lines data/make-parallel.sh greps, emitted
        when a phase's last leg publishes."""
        rounds = self.manifest.rounds()
        for rnd, label in ((-1, "Sorted"), (0, "Mapped")):
            legs = rounds.get(rnd, [])
            if legs and not phase_done[rnd] \
                    and all(leg.state == DONE for leg in legs):
                phase_done[rnd] = True
                print(f"{label} in {time.time() - t0:.8f} seconds.",
                      flush=True)


# ---------------------------------------------------------------------------
# Resume: fsck the surviving artifacts, keep the clean legs
# ---------------------------------------------------------------------------


def _artifact_clean(path: str, mode: str, expect_sig: str | None) -> bool:
    if not os.path.exists(path):
        return False
    try:
        sig = _validate_artifact(path, path, mode)
    except (IntegrityError, OSError, SupervisionFailed):
        return False
    if expect_sig and sig and sig != expect_sig:
        return False
    return True


def reconcile(manifest: Manifest, mode: str) -> tuple[int, int]:
    """Mark dirty/missing done-legs pending again; returns
    (clean_kept, redispatched).  Only artifacts still NEEDED are checked —
    a corrupt intermediate whose consumers all finished costs nothing."""
    cache: dict[str, bool] = {}

    def clean(path: str) -> bool:
        if path not in cache:
            cache[path] = _artifact_clean(path, mode, manifest.sig)
        return cache[path]

    changed = True
    while changed:
        changed = False
        required = {manifest.final_tree}
        required.update(p for leg in manifest.legs
                        if leg.state != DONE for p in leg.inputs)
        for leg in manifest.legs:
            if leg.state == DONE and leg.output in required \
                    and not clean(leg.output):
                leg.state = PENDING
                changed = True
    dirty = sum(1 for leg in manifest.legs if leg.state != DONE)
    return len(manifest.legs) - dirty, dirty


def run_supervised(graph: str, state_dir: str,
                   config: SupervisorConfig | None = None, runner=None,
                   seq_file: str | None = None,
                   out_file: str | None = None) -> Manifest:
    """Run (or resume) one supervised tournament; returns the completed
    manifest.  ``state_dir`` holds the manifest, ALL tournament artifacts
    (including the final tree — so a resume never depends on a caller's
    possibly-cleaned trial dir), and worker logs; rerunning with the same
    dir resumes off the fsck'd survivors.  ``seq_file``: an existing
    sequence (skip the sort leg).  ``out_file``: where to export a copy
    of the final tree (+ sidecar) after completion — an export, not the
    durable copy, so reruns and multi-trial drivers can point it anywhere.
    """
    config = config or SupervisorConfig.from_env()
    os.makedirs(state_dir, exist_ok=True)
    # a dead predecessor's write debris: atomic-write temps and attempt
    # files are unpublished by construction — reclaim before they count
    # against the disk budget (and before attempt names could collide)
    gc_orphan_temps(state_dir)
    sweep_attempt_debris(state_dir)
    base = os.path.basename(graph)
    for suffix in (".dat", ".net"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    prefix = os.path.join(state_dir, base)
    final = prefix + ".tre"

    if os.path.exists(manifest_path(state_dir)):
        manifest = load_manifest(state_dir, config.integrity)
        size = os.path.getsize(graph) if os.path.exists(graph) else -1
        if manifest.graph != graph or manifest.graph_bytes != size:
            raise SupervisionFailed(
                f"{state_dir}: manifest belongs to a different build "
                f"({manifest.graph}, {manifest.graph_bytes} bytes; this "
                f"run: {graph}, {size} bytes) — refusing to resume; use "
                f"a fresh state dir")
        clean, dirty = reconcile(manifest, resolve_policy(config.integrity))
        config.events.append(("resume", clean, dirty))
    else:
        manifest = plan_tournament(graph, prefix, final, config.workers,
                                   config.reduction, seq_file)
    save_manifest(manifest, state_dir)
    manifest = TournamentSupervisor(manifest, state_dir, config,
                                    runner).run()
    if out_file and out_file != manifest.final_tree:
        # export copy, sidecar first (the sheep_mv_artifact ordering)
        if os.path.exists(manifest.final_tree + ".sum"):
            shutil.copyfile(manifest.final_tree + ".sum", out_file + ".sum")
        shutil.copyfile(manifest.final_tree, out_file)
    return manifest
