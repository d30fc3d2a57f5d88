"""Live tenant migration: epoch-fenced cutover, zero acked-insert loss.

A tenant is nailed to the cluster the router's hash ring first picked;
this module moves one LIVE — under routed insert+read traffic — to
another cluster.  Three phases, each resumable or cleanly
abortable back to the source across kill -9 at any boundary:

  phase 1  SNAP    the target leader adopts the tenant and bootstraps
                   its state dir via the crc-verified snapshot transfer
                   (replicate.bootstrap_state_dir: sidecar-first
                   landing, fsck as the sole admission gate) — the
                   ``msnap`` netfault site guards the fetch
  phase 2  DELTA   the target streams the source leader's delta WAL as
                   a migration follower (``REPL HELLO mig=1`` → the
                   same APPEND framing with per-frame crc, gap-NACK
                   re-stream, idempotent-by-seqno dup handling; APPENDs
                   arm the ``mdelta`` site) until lag ~ 0
  phase 3  CUTOVER the epoch-fenced handover, in this exact order:
                   (a) the source seals + durably fences the tenant —
                   every later client verb answers a typed ``ERR moved
                   dest=<cluster>``, never a silent drop; (b) the delta
                   stream drains to the source's FINAL applied seqno
                   (re-confirmed against the source after the target
                   catches up, so no acked insert can hide in flight);
                   (c) the target advances the tenant epoch DURABLY
                   before accepting its first write (MIG CUT); (d) the
                   router remaps the tenant atomically and replays
                   in-flight writes — a write refused by the fence was
                   never applied at the source, so its replay at the
                   target is a first apply, not a double one.  Cutover
                   RPCs arm the ``mcut`` site.

Ownership invariant: a tenant is never unowned and never dual-owned in
the same epoch.  The fence is durable (tenants.MOVED_MARKER) before the
remap; the target's epoch advance is durable before its first write;
and while the migration is in flight the target refuses writes to the
inbound tenant (daemon INSERT guard) because it still holds the
SOURCE's epoch.  Abort is legal exactly until MIG CUT succeeds: drop
the target's adopted copy, lift the source fence, nothing was lost
because nothing ever acked anywhere but the source.  After CUT the only
way out is forward — the driver finishes the remap instead of
un-advancing an epoch (epochs only advance).

The router persists one manifest per migration (``migrate-<tenant>
.json``, tmp+fsync+rename) so a kill -9'd router resumes where it
stopped; every daemon-side MIG op is idempotent so resuming means
re-issuing, not reconstructing.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

from . import netfaults
from .protocol import ServeError

#: overall per-migration budget; past it the driver aborts back to the
#: source (or, after CUT, keeps pushing the remap forward)
TIMEOUT_ENV = "SHEEP_MIGRATE_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 120.0
#: delta lag (records) at or under which the driver enters cutover
LAG_CUT_ENV = "SHEEP_MIGRATE_LAG_CUT"
DEFAULT_LAG_CUT = 8
#: driver poll cadence while watching the delta lag drain
POLL_ENV = "SHEEP_MIGRATE_POLL_S"
DEFAULT_POLL_S = 0.05
#: wire-leg retry budget per migration RPC (each retry is a counted
#: re-dispatch; exhausting it aborts the migration)
RETRIES_ENV = "SHEEP_MIGRATE_RETRIES"
DEFAULT_RETRIES = 8

#: adopted tenants land under the target daemon's own state dir
MIG_DIR_PREFIX = "mig-"

PHASE_SNAP = "snap"
PHASE_DELTA = "delta"
PHASE_CUTOVER = "cutover"
PHASE_DONE = "done"
PHASE_ABORTED = "aborted"

#: how long the source-side seal waits for pre-fence inserts to drain
#: (applied seqno stable across polls); the driver's re-confirm loop is
#: the exact gate, this is the fast path
_SEAL_STABLE_S = 0.15
_SEAL_CAP_S = 3.0


class MigrationError(RuntimeError):
    """A migration step this node cannot honor right now (typed
    ``ERR unavailable`` on the wire; the driver retries or aborts)."""


def _knob_float(env: str, default: float) -> float:
    try:
        return float(os.environ.get(env, "") or default)
    except ValueError:
        return default


def _knob_int(env: str, default: int) -> int:
    try:
        return int(os.environ.get(env, "") or default)
    except ValueError:
        return default


# -- daemon-side ops (serve/daemon.py MIG verb delegates here) --------------


def _msnap_bootstrap(state_dir: str, host: str, port: int,
                     tenant: str) -> int:
    """Phase-1 snapshot landing with the ``msnap`` netfault site armed.
    drop/partition kill the fetch (the driver retries the whole phase —
    the tmp+rename landing means a torn fetch admitted nothing); dup
    fetches twice and lands once (idempotent by construction)."""
    from .replicate import bootstrap_state_dir, fetch_snapshot
    timeout_s = _knob_float(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)
    kind = netfaults.arm("msnap")
    if kind == "slow":
        time.sleep(netfaults.SLOW_S)
    if kind in ("drop", "partition"):
        raise MigrationError(f"netfault: msnap {kind}")
    seqno = bootstrap_state_dir(state_dir, host, port,
                                timeout_s=timeout_s, tenant=tenant)
    if kind == "dup":
        # duplicate delivery: the second blob arrives and is discarded
        # (the landed snapshot already passed crc + fsck)
        fetch_snapshot(host, port, timeout_s=timeout_s, tenant=tenant)
    return seqno


def target_adopt(daemon, name: str, host: str, port: int) -> dict:
    """MIG ADOPT on the target leader: register + bootstrap + start the
    delta stream.  Idempotent and the resume entry point — re-issuing
    after a kill -9 skips whatever already landed and re-pins the delta
    stream to ``host:port`` (which may be a NEW source leader after a
    source-side failover)."""
    from .replicate import Replicator
    from .state import snap_paths
    mgr = daemon.tenants
    try:
        t = mgr.get(name)
        if t.graph is not None or (t.mig is None and t.core is not None
                                   and t.moved_dest is None
                                   and snap_paths(t.state_dir)
                                   and not _is_adopted(mgr, name)):
            raise MigrationError(
                f"target already hosts tenant {name!r}; refusing to "
                f"overwrite it with a migrated copy")
    except KeyError:
        t = mgr.adopt(name, os.path.join(daemon.core.state_dir,
                                         MIG_DIR_PREFIX + name))
    src = f"{host}:{port}"
    if not (os.path.isdir(t.state_dir) and snap_paths(t.state_dir)):
        t.mig = {"phase": PHASE_SNAP, "src": src, "replicator": None}
        _msnap_bootstrap(t.state_dir, host, port, name)
    core = mgr.core_of(name, _count_restore=False)
    old = t.mig or {}
    rep = old.get("replicator")
    if rep is not None and old.get("src") != src:
        rep.stop()  # the source leader moved: re-pin the stream
        rep = None
    if rep is None:
        rep = Replicator(core, daemon.node_id + ":mig",
                         lambda: (host, port), hb_s=daemon.cluster.hb_s,
                         events=daemon.config.events, tenant=name,
                         mig=True).start()
    t.mig = {"phase": PHASE_DELTA, "src": src, "replicator": rep}
    return {"tenant": name, "phase": PHASE_DELTA,
            "applied": core.applied_seqno, "epoch": core.epoch}


def _is_adopted(mgr, name: str) -> bool:
    return any(r.get("name") == name for r in mgr._load_adopted())


def source_seal(daemon, name: str, dest: str) -> dict:
    """MIG SEAL on the source leader: durably fence the tenant as moved
    to ``dest`` (typed ``ERR moved`` refusals from here on), seal its
    snapshot, and report the applied seqno AFTER pre-fence inserts
    drain — the number the cutover must see on the target.  Idempotent:
    re-sealing an already-fenced tenant re-reports."""
    mgr = daemon.tenants
    t = mgr.get(name)
    core = mgr.core_of(name, _count_restore=False)
    t.fence_moved(dest)
    # drain: an insert that passed the fence check before the fence
    # landed may still be applying; wait for the applied seqno to go
    # quiet so the reported cut target covers every acked insert (the
    # driver's source re-confirm loop is the exact backstop)
    deadline = time.monotonic() + _SEAL_CAP_S
    last, quiet_since = core.applied_seqno, time.monotonic()
    while time.monotonic() < deadline:
        cur = core.applied_seqno
        if cur != last:
            last, quiet_since = cur, time.monotonic()
        elif time.monotonic() - quiet_since >= _SEAL_STABLE_S:
            break
        time.sleep(0.01)
    try:
        core.seal_snapshot()
    except OSError as exc:
        raise MigrationError(f"seal failed ({exc}); tenant stays "
                             f"fenced — retry or UNSEAL to abort")
    return {"tenant": name, "dest": dest,
            "applied": core.applied_seqno, "epoch": core.epoch}


def source_unseal(daemon, name: str) -> dict:
    """MIG UNSEAL on the source leader: lift the fence (migration
    abort).  The DRIVER guarantees this is never issued after the
    target's epoch advanced — that ordering is the dual-ownership
    guard, not anything this function can check locally."""
    t = daemon.tenants.get(name)
    if t.moved_dest is None:
        return {"tenant": name, "already": 1}
    t.unfence_moved()
    return {"tenant": name, "unfenced": 1}


def target_cut(daemon, name: str, epoch: int, expect: int) -> dict:
    """MIG CUT on the target leader: verify the delta drained to
    ``expect``, stop the migration stream, and advance the tenant epoch
    DURABLY — only then do writes open (the daemon's INSERT guard keys
    on ``t.mig``).  Idempotent: a re-issued CUT against an already-
    advanced epoch reports success."""
    mgr = daemon.tenants
    t = mgr.get(name)
    core = mgr.core_of(name, _count_restore=False)
    if core.epoch >= epoch:
        _stop_mig_stream(t)
        t.mig = None
        return {"tenant": name, "epoch": core.epoch,
                "applied": core.applied_seqno, "already": 1}
    if core.applied_seqno < expect:
        raise MigrationError(
            f"delta not drained: applied {core.applied_seqno} < "
            f"expect {expect} (lag "
            f"{expect - core.applied_seqno})")
    _stop_mig_stream(t)
    try:
        core.advance_epoch(epoch)
    except OSError as exc:
        # epoch NOT advanced (advance_epoch restored it): stay fenced
        # against writes so the driver can retry or abort
        t.mig = {"phase": PHASE_DELTA, "src": (t.mig or {}).get("src"),
                 "replicator": None}
        raise MigrationError(f"epoch seal failed ({exc})")
    t.mig = None
    return {"tenant": name, "epoch": core.epoch,
            "applied": core.applied_seqno}


def _stop_mig_stream(t) -> None:
    if t.mig is not None:
        rep = t.mig.get("replicator")
        if rep is not None:
            rep.stop()
            t.mig["replicator"] = None


def target_drop(daemon, name: str) -> dict:
    """MIG DROP on the target leader: discard an adopted copy
    (migration abort).  Refuses tenants this daemon hosts for any
    reason other than adoption; idempotent on a never-adopted name."""
    mgr = daemon.tenants
    try:
        t = mgr.get(name)
    except KeyError:
        return {"tenant": name, "dropped": 0, "already": 1}
    _stop_mig_stream(t)
    t.mig = None
    return {"tenant": name, "dropped": int(mgr.drop(name))}


def mig_stat(daemon, name: str) -> dict:
    """MIG STAT anywhere: the tenant's migration-relevant numbers."""
    mgr = daemon.tenants
    t = mgr.get(name)
    rec: dict = {"tenant": name, "role": daemon.role}
    core = t.core
    if core is None:
        from .state import snap_paths
        if os.path.isdir(t.state_dir) and snap_paths(t.state_dir):
            core = mgr.core_of(name, _count_restore=False)
    if core is not None:
        rec["applied"] = core.applied_seqno
        rec["epoch"] = core.epoch
        rec["crc"] = core.state_crc()
    else:
        rec["applied"] = 0
        rec["epoch"] = 0
    if t.mig is not None:
        rec["phase"] = t.mig.get("phase", "?")
        rep = t.mig.get("replicator")
        rec["lag"] = rep.lag if rep is not None else -1
    elif t.moved_dest is not None:
        rec["phase"] = "moved"
        rec["dest"] = t.moved_dest
    else:
        rec["phase"] = "-"
    return rec


# -- the router-side driver -------------------------------------------------


def manifest_path(state_dir: str, tenant: str) -> str:
    return os.path.join(state_dir, f"migrate-{tenant}.json")


def load_manifests(state_dir: str) -> list[dict]:
    """Every persisted migration manifest in the router's state dir
    (resume scan); unreadable files are skipped, never fatal."""
    out = []
    try:
        names = os.listdir(state_dir)
    except OSError:
        return out
    for n in sorted(names):
        if not (n.startswith("migrate-") and n.endswith(".json")):
            continue
        try:
            with open(os.path.join(state_dir, n)) as f:
                rec = json.load(f)
            if isinstance(rec, dict) and rec.get("tenant"):
                out.append(rec)
        except (OSError, ValueError):
            continue
    return out


class Migration:
    """One tenant's migration, driven from the router.  ``run()`` walks
    the phases; every wire leg goes through :meth:`_rpc` (retried, and
    armed at the ``mcut`` site during cutover) and every phase change
    persists the manifest first, so kill -9 anywhere resumes."""

    def __init__(self, router, tenant: str, dest: str,
                 resume: dict | None = None):
        self.router = router
        self.tenant = tenant
        self.dest = dest
        rec = resume or {}
        self.src = rec.get("src") or router.placement_of(tenant)
        self.phase = rec.get("phase", PHASE_SNAP)
        self.cut_done = bool(rec.get("cut_done"))
        self.seal_epoch = rec.get("seal_epoch")
        self.seal_applied = rec.get("seal_applied")
        self.redispatches = 0
        self.last_lag: int | None = None
        self.error: str | None = None
        self.done = threading.Event()
        self.thread: threading.Thread | None = None
        self.timeout_s = _knob_float(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)
        self.lag_cut = _knob_int(LAG_CUT_ENV, DEFAULT_LAG_CUT)
        self.poll_s = _knob_float(POLL_ENV, DEFAULT_POLL_S)
        self.retries = _knob_int(RETRIES_ENV, DEFAULT_RETRIES)

    # -- persistence -------------------------------------------------------

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "src": self.src,
                "dest": self.dest, "phase": self.phase,
                "cut_done": self.cut_done,
                "seal_epoch": self.seal_epoch,
                "seal_applied": self.seal_applied,
                "redispatches": self.redispatches,
                "error": self.error}

    def _save(self) -> None:
        sd = self.router.state_dir
        if sd is None:
            return
        path = manifest_path(sd, self.tenant)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.to_dict(), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            pass  # non-durable router: still migrates, cannot resume

    # -- wire legs ---------------------------------------------------------

    def _leader_of(self, cid: str, refresh: bool = False):
        """(cluster, (host, port)) of ``cid``'s current leader."""
        cluster = self.router.cluster_by_id(cid)
        if cluster is None:
            raise MigrationError(f"unknown cluster {cid!r}")
        leader = cluster.leader(refresh=refresh)
        if leader is None:
            raise MigrationError(f"cluster {cid} has no reachable "
                                 f"leader")
        return cluster, leader

    def _rpc(self, cid: str, line: str, site: str | None = None) -> dict:
        """One migration RPC to ``cid``'s leader, retried across
        netfaults/dead leaders; each retry counts a re-dispatch.  A
        typed ERR other than notleader surfaces as MigrationError."""
        last = "?"
        for attempt in range(self.retries + 1):
            if attempt:
                self.redispatches += 1
                time.sleep(min(0.25, self.poll_s * (1 + attempt)))
            refresh = attempt > 0
            try:
                cluster, (host, port) = self._leader_of(
                    cid, refresh=refresh)
            except MigrationError as exc:
                last = str(exc)
                continue
            kind = netfaults.arm(site) if site else None
            if kind == "slow":
                time.sleep(netfaults.SLOW_S)
            if kind in ("drop", "partition"):
                last = f"netfault: {site} {kind}"
                continue
            try:
                with socket.create_connection(
                        (host, port), timeout=10.0) as s:
                    rf = s.makefile("rb")
                    payload = (line + "\n").encode("ascii")
                    s.sendall(payload)
                    if kind == "dup":
                        s.sendall(payload)  # idempotent second landing
                    resp = rf.readline().decode("ascii").strip()
                    if not resp:
                        raise ConnectionError("peer closed mid-RPC")
            except (OSError, ConnectionError) as exc:
                cluster.forget_leader()
                last = str(exc)
                continue
            toks = resp.split()
            if toks and toks[0] == "OK":
                out = {}
                for f in toks[1:]:
                    k, _, v = f.partition("=")
                    out[k] = v
                return out
            code = toks[1] if len(toks) > 1 else "?"
            if code == "notleader":
                hint = toks[2] if len(toks) > 2 else "-"
                if hint != "-":
                    cluster.set_leader_hint(hint)
                else:
                    cluster.forget_leader()
                last = resp
                continue
            if code == "unavailable":
                last = resp  # transient (lag not drained, seal retry)
                continue
            raise MigrationError(f"{line.split()[0]} "
                                 f"{line.split()[1]}: {resp}")
        raise MigrationError(
            f"migration RPC exhausted {self.retries} retries "
            f"({line.split(None, 2)[:2]}): {last}")

    # -- the drive ---------------------------------------------------------

    def start(self) -> "Migration":
        self.thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"migrate:{self.tenant}")
        self.thread.start()
        return self

    def run(self) -> None:
        try:
            self._run()
        except MigrationError as exc:
            self._abort(str(exc))
        except Exception as exc:  # never leave a migration undecided
            self._abort(f"{type(exc).__name__}: {exc}")
        finally:
            self.router.migration_finished(self)
            self.done.set()

    def _src_leader_hostport(self) -> tuple[str, int]:
        _, (host, port) = self._leader_of(self.src, refresh=False)
        return host, port

    def _run(self) -> None:
        deadline = time.monotonic() + self.timeout_s
        if self.cut_done:
            # resume after kill -9 between CUT and remap: forward only
            self._finish()
            return
        # phases 1+2: adopt (idempotent: skips what already landed,
        # re-pins the delta stream) then drain the lag
        self.phase = PHASE_SNAP if self.phase == PHASE_SNAP \
            else PHASE_DELTA
        self._save()
        host, port = self._src_leader_hostport()
        self._rpc(self.dest,
                  f"MIG ADOPT {self.tenant} host={host} port={port}")
        self.phase = PHASE_DELTA
        self._save()
        last_applied, stuck_since = -1, time.monotonic()
        while True:
            if time.monotonic() > deadline:
                raise MigrationError(
                    f"delta lag did not drain inside {self.timeout_s:g}s "
                    f"(last lag {self.last_lag})")
            st = self._rpc(self.dest, f"MIG STAT {self.tenant}")
            lag = int(st.get("lag", -1))
            applied = int(st.get("applied", 0))
            self.last_lag = max(0, lag)
            if 0 <= lag <= self.lag_cut:
                break
            if applied > last_applied:
                last_applied, stuck_since = applied, time.monotonic()
            elif time.monotonic() - stuck_since > max(1.0,
                                                      20 * self.poll_s):
                # no progress: the source leader may have moved (kill
                # -9 / failover) — re-resolve and re-pin the stream
                try:
                    _, (h, p) = self._leader_of(self.src, refresh=True)
                    self._rpc(self.dest, f"MIG ADOPT {self.tenant} "
                                         f"host={h} port={p}")
                except MigrationError:
                    pass  # keep polling; the deadline is the backstop
                stuck_since = time.monotonic()
            time.sleep(self.poll_s)
        # phase 3: fence -> drain-to-final -> epoch -> remap
        self.phase = PHASE_CUTOVER
        self._save()
        seal = self._rpc(self.src,
                         f"MIG SEAL {self.tenant} dest={self.dest}",
                         site="mcut")
        self.seal_epoch = int(seal["epoch"])
        self.seal_applied = int(seal["applied"])
        self._save()
        expect = self.seal_applied
        while True:
            if time.monotonic() > deadline:
                raise MigrationError(
                    f"cutover drain did not reach seqno {expect} "
                    f"inside {self.timeout_s:g}s")
            st = self._rpc(self.dest, f"MIG STAT {self.tenant}")
            if int(st.get("applied", 0)) >= expect:
                # re-confirm against the source: an insert that slipped
                # in before the fence landed moves the goalpost once,
                # never silently
                s2 = self._rpc(self.src, f"MIG STAT {self.tenant}")
                src_applied = int(s2.get("applied", 0))
                if src_applied <= expect:
                    break
                expect = src_applied
                self.seal_applied = expect
                self._save()
            self.last_lag = max(0, expect - int(st.get("applied", 0)))
            time.sleep(self.poll_s)
        self._rpc(self.dest,
                  f"MIG CUT {self.tenant} epoch={self.seal_epoch + 1} "
                  f"expect={expect}", site="mcut")
        self.cut_done = True
        self._save()
        self._finish()

    def _finish(self) -> None:
        self.router.remap(self.tenant, self.dest)
        self.phase = PHASE_DONE
        self.last_lag = 0
        self._save()

    def _abort(self, why: str) -> None:
        self.error = why
        if self.cut_done:
            # the target's epoch advanced: abort-back would dual-own
            # the tenant, so the only exit is forward
            try:
                self._finish()
                return
            except Exception:
                pass  # manifest keeps cut_done: the next resume retries
            return
        # back to source: drop the target's copy, lift the fence —
        # order matters (the fence lifts LAST, so at no instant is the
        # tenant writable in two places)
        for cid, line in ((self.dest, f"MIG DROP {self.tenant}"),
                          (self.src, f"MIG UNSEAL {self.tenant}")):
            try:
                self._rpc(cid, line, site="mcut")
            except MigrationError:
                pass  # best-effort; idempotent on resume/retry
        self.phase = PHASE_ABORTED
        self._save()
