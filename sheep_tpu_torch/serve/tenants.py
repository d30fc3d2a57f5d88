"""Multi-tenancy: N serve state dirs behind one daemon.

One daemon process used to mean one graph.  Production framing — many
graphs, many users — wants N graphs behind one selectors loop instead of
N processes each paying a listener, a worker pool, and an idle-time RSS
floor.  A *tenant* is exactly one serve state dir (snapshots + WAL
+ drift accounting), and everything crash-safety already proved about
one state dir holds per tenant by construction: the cores never share a
single array, WAL, or admission slot pool.

    SHEEP_SERVE_TENANTS = entry[,entry...]
    entry               = name=state_dir[:graph[:num_parts]]

(also ``--tenant name=dir[:graph[:k]]``, repeatable, on ``cli/serve.py``).
The ``default`` tenant is the daemon's ``-d`` state dir and is what a
connection talks to until it selects otherwise — the single-tenant wire grammar
is byte-identical for it.  ``TENANT <name>`` is connection-scoped: it
re-points THAT connection's verbs at another tenant's core (the router
issues it once per upstream connection).

**Memory: governor-priced eviction.**  Resident tenants are priced by
:func:`~sheep_tpu_torch.resources.governor.serve_tenant_nbytes`; when the
process crosses the ``SHEEP_MEM_BUDGET`` soft threshold (the same
signal that turns inserts read-only) — or the operator capped resident
tenants with ``SHEEP_SERVE_MAX_RESIDENT`` — the coldest evictable
tenant is sealed to a snapshot generation and dropped from memory.
Eviction is the clean-shutdown path (seal + close), so the evicted
state is bit-identical by the same argument a restart is; the next verb
that touches the tenant lazily restores it through ``ServeCore.open`` —
the exact crash-recovery path, exercised on every eviction cycle.  A
tenant with attached replication streams never evicts (its followers
would have to re-handshake for nothing); the default tenant never
evicts (it IS the daemon's published identity).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

from ..resources.governor import ResourceGovernor, serve_tenant_nbytes
from .state import ServeCore, snap_paths

TENANTS_ENV = "SHEEP_SERVE_TENANTS"
MAX_RESIDENT_ENV = "SHEEP_SERVE_MAX_RESIDENT"

DEFAULT_TENANT = "default"

#: the migration fence marker: a tenant state dir holding
#: this file has been MOVED — its daemon refuses every client verb with
#: ``ERR moved dest=<cluster>`` even across restarts, so a kill -9'd
#: source can never resurrect as a second owner of a migrated tenant
MOVED_MARKER = "tenant.moved"

#: adopted-tenant registry: migration targets persist the
#: tenants they adopted (they are not in SHEEP_SERVE_TENANTS) so a
#: kill -9 mid-migration leaves the tenant registered after restart
ADOPTED_FILE = "tenants.adopted.json"


def moved_marker_path(state_dir: str) -> str:
    return os.path.join(state_dir, MOVED_MARKER)


def read_moved_marker(state_dir: str) -> str | None:
    """The destination cluster named by a tenant dir's fence marker, or
    None when the tenant was never migrated away."""
    try:
        with open(moved_marker_path(state_dir)) as f:
            rec = json.load(f)
        return str(rec["dest"])
    except (OSError, ValueError, KeyError):
        return None


def write_moved_marker(state_dir: str, dest: str) -> None:
    """Durably fence a tenant dir: tmp + fsync + rename, so the fence
    either fully exists or does not — a torn fence is no fence, and the
    cutover driver retries until the marker reads back."""
    path = moved_marker_path(state_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"dest": dest, "at": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def clear_moved_marker(state_dir: str) -> None:
    try:
        os.unlink(moved_marker_path(state_dir))
    except OSError:
        pass


@dataclass
class TenantSpec:
    """One parsed ``name=dir[:graph[:k]]`` entry."""

    name: str
    state_dir: str
    graph: str | None = None
    num_parts: int = 2


def parse_tenant_specs(spec: str) -> list[TenantSpec]:
    """``SHEEP_SERVE_TENANTS`` / ``--tenant`` grammar -> specs.  Raises
    ValueError on garbage — a misspelled tenant must never silently
    vanish from the fleet."""
    out: list[TenantSpec] = []
    seen = set()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, rest = entry.partition("=")
        name = name.strip()
        if not sep or not name or not rest:
            raise ValueError(
                f"tenant entry {entry!r}: want name=dir[:graph[:k]]")
        if name == DEFAULT_TENANT:
            raise ValueError(
                f"tenant entry {entry!r}: {DEFAULT_TENANT!r} is the "
                f"daemon's -d state dir, not a named tenant")
        if name in seen:
            raise ValueError(f"tenant {name!r} named twice")
        seen.add(name)
        parts = rest.split(":")
        state_dir = parts[0]
        graph = parts[1] if len(parts) > 1 and parts[1] else None
        k = int(parts[2]) if len(parts) > 2 and parts[2] else 2
        if not state_dir:
            raise ValueError(f"tenant entry {entry!r}: empty state dir")
        out.append(TenantSpec(name=name, state_dir=state_dir,
                              graph=graph, num_parts=k))
    return out


class UnknownTenant(KeyError):
    """``TENANT x`` named a tenant this daemon does not host."""

    def __init__(self, name: str, known):
        super().__init__(name)
        self.name = name
        self.message = (f"unknown tenant {name!r} (hosting: "
                        f"{'/'.join(sorted(known))})")


class Tenant:
    """One tenant's runtime state inside the daemon."""

    __slots__ = ("name", "state_dir", "graph", "num_parts", "core",
                 "admission", "hub", "replicator", "last_touch",
                 "evictions", "restores", "moved_dest", "mig")

    def __init__(self, name: str, state_dir: str, graph: str | None,
                 num_parts: int, core: ServeCore | None):
        self.name = name
        self.state_dir = state_dir
        self.graph = graph
        self.num_parts = num_parts
        self.core = core
        self.admission = None      # set by the daemon (per-tenant slots)
        self.hub = None            # leader-side ReplicationHub
        self.replicator = None     # follower-side Replicator
        self.last_touch = time.monotonic()
        self.evictions = 0
        self.restores = 0
        # migration state: moved_dest is the fence — set =
        # every client verb refuses ``ERR moved dest=<cluster>``; it is
        # re-read from the durable marker so restarts stay fenced.  mig
        # is the TARGET side's live migration record (phase / source /
        # delta puller) while an adoption is in flight, None otherwise.
        self.moved_dest = read_moved_marker(state_dir)
        self.mig = None

    def fence_moved(self, dest: str) -> None:
        """Durably fence this tenant as moved to ``dest`` (idempotent)."""
        write_moved_marker(self.state_dir, dest)
        self.moved_dest = dest

    def unfence_moved(self) -> None:
        """Abort path: lift the fence — legal ONLY while the target has
        not advanced the tenant epoch (the cutover driver's invariant)."""
        clear_moved_marker(self.state_dir)
        self.moved_dest = None

    @property
    def resident(self) -> bool:
        return self.core is not None

    def evictable(self) -> bool:
        """Cold-evictable: resident, not the default, and no replication
        machinery would be stranded by dropping the core.  A tenant with
        an in-flight re-sequence is pinned too: sealing it
        out of memory would orphan the rebuild mid-phase.  A quarantined
        tenant is pinned hardest of all: eviction SEALS the
        in-memory state to a snapshot, and its state is exactly what the
        quarantine says not to trust — sealing it would launder the
        divergence into a sidecar-vouched artifact."""
        if self.name == DEFAULT_TENANT or self.core is None:
            return False
        if self.replicator is not None or self.mig is not None:
            return False
        if getattr(self.core, "quarantined", False):
            return False
        if self.core.state_dir:
            from .reseq import active
            if active(self.core.state_dir):
                return False
            from .scrub import read_quarantine
            if read_quarantine(self.core.state_dir) is not None:
                return False
        return self.hub is None or self.hub.follower_count() == 0

    def priced_nbytes(self) -> int:
        core = self.core
        if core is None:
            return 0
        return serve_tenant_nbytes(len(core.seq), len(core.parts),
                                   len(core.ins_tail))


class TenantManager:
    """The daemon's tenant table: selection, lazy restore, and the
    governor-priced eviction policy.  Thread-safe: one RLock guards the
    table; restore/evict run under it (restores are rare and bounded by
    snapshot load time)."""

    def __init__(self, default_core: ServeCore,
                 specs: list[TenantSpec] | None = None,
                 governor: ResourceGovernor | None = None,
                 open_kw: dict | None = None,
                 max_resident: int | None = None):
        self.governor = governor if governor is not None \
            else default_core.governor
        self.open_kw = dict(open_kw or {})
        if max_resident is None and os.environ.get(MAX_RESIDENT_ENV):
            max_resident = int(os.environ[MAX_RESIDENT_ENV])
        self.max_resident = max_resident
        self._lock = threading.RLock()
        self._tenants: dict[str, Tenant] = {}
        dflt = Tenant(DEFAULT_TENANT, default_core.state_dir, None, 2,
                      default_core)
        self._tenants[DEFAULT_TENANT] = dflt
        for spec in specs or []:
            self._tenants[spec.name] = Tenant(
                spec.name, spec.state_dir, spec.graph, spec.num_parts,
                None)
        # re-register tenants a previous incarnation adopted mid-
        # migration: spec'd names win — an operator adding
        # the tenant to SHEEP_SERVE_TENANTS after the move is the
        # steady-state ending of a migration story
        self._adopted_path = os.path.join(default_core.state_dir,
                                          ADOPTED_FILE)
        for rec in self._load_adopted():
            name = rec.get("name")
            if name and name not in self._tenants:
                self._tenants[name] = Tenant(
                    name, rec["state_dir"], rec.get("graph"),
                    int(rec.get("num_parts", 2)), None)

    @classmethod
    def from_env(cls, default_core: ServeCore, extra_specs=None,
                 **kw) -> "TenantManager":
        specs = list(extra_specs or [])
        env = os.environ.get(TENANTS_ENV, "")
        if env:
            names = {s.name for s in specs}
            specs += [s for s in parse_tenant_specs(env)
                      if s.name not in names]
        return cls(default_core, specs, **kw)

    # -- adoption (migration targets) -------------------------------------

    def _load_adopted(self) -> list[dict]:
        try:
            with open(self._adopted_path) as f:
                recs = json.load(f)
            return recs if isinstance(recs, list) else []
        except (OSError, ValueError):
            return []

    def _save_adopted(self, recs: list[dict]) -> None:
        tmp = self._adopted_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(recs, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._adopted_path)

    def adopt(self, name: str, state_dir: str, graph: str | None = None,
              num_parts: int = 2) -> Tenant:
        """Dynamically register ``name`` (a migration target adopting an
        inbound tenant).  Durable BEFORE the tenant exists in memory —
        kill -9 between the registry write and the snapshot landing
        leaves a registered-but-empty tenant the resumed migration
        re-bootstraps, never an unregistered state dir.  Idempotent:
        re-adopting an already-registered tenant returns the entry."""
        if name == DEFAULT_TENANT:
            raise ValueError("cannot adopt the default tenant")
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                return t
            recs = [r for r in self._load_adopted()
                    if r.get("name") != name]
            recs.append({"name": name, "state_dir": state_dir,
                         "graph": graph, "num_parts": num_parts})
            self._save_adopted(recs)
            t = Tenant(name, state_dir, graph, num_parts, None)
            self._tenants[name] = t
            return t

    def drop(self, name: str) -> bool:
        """Unregister an ADOPTED tenant (migration abort: the target
        discards its partial copy).  Spec'd/default tenants refuse —
        only what adopt() added can be dropped.  The state dir is left
        on disk for the driver to discard; False when not adopted."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                return False
            recs = self._load_adopted()
            if not any(r.get("name") == name for r in recs):
                return False
            if t.core is not None:
                t.core.close()
                t.core = None
            self._save_adopted([r for r in recs
                                if r.get("name") != name])
            del self._tenants[name]
            return True

    # -- lookups -----------------------------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def __len__(self) -> int:
        return len(self._tenants)

    def get(self, name: str) -> Tenant:
        """The tenant entry (resident or not); UnknownTenant if this
        daemon does not host ``name``."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                raise UnknownTenant(name, self._tenants)
            return t

    def resident_names(self) -> list[str]:
        with self._lock:
            return sorted(n for n, t in self._tenants.items()
                          if t.resident)

    # -- the touch path ----------------------------------------------------

    def core_of(self, name: str, _count_restore: bool = True) -> ServeCore:
        """The tenant's live core, lazily restored (or first-touch
        bootstrapped from its spec'd graph) when evicted.  The ONE entry
        point the request path uses — every touch stamps LRU time."""
        with self._lock:
            t = self.get(name)
            t.last_touch = time.monotonic()
            if t.core is None:
                t.core = self._open(t)
                if _count_restore:
                    t.restores += 1
            return t.core

    def _open(self, t: Tenant) -> ServeCore:
        if os.path.isdir(t.state_dir) and snap_paths(t.state_dir):
            return ServeCore.open(t.state_dir, governor=self.governor,
                                  **self.open_kw)
        if t.graph is None:
            raise FileNotFoundError(
                f"tenant {t.name!r}: {t.state_dir} holds no snapshots "
                f"and no graph was spec'd to bootstrap from")
        return ServeCore.bootstrap(t.state_dir, graph_path=t.graph,
                                   num_parts=t.num_parts,
                                   governor=self.governor,
                                   **self.open_kw)

    def open_all(self) -> None:
        """Eagerly open/bootstrap every tenant (daemon start on a leader
        or standalone: followers must be able to HELLO immediately).
        The start-time open is not a "restore" — that counter tracks
        evict/lazy-restore cycles.  An adopted-but-empty tenant (kill -9
        landed between the adoption registry write and the snapshot
        fetch) stays cold — the resumed migration re-bootstraps it."""
        for name in self.names():
            with self._lock:
                t = self.get(name)
                if t.core is None and t.graph is None \
                        and not (os.path.isdir(t.state_dir)
                                 and snap_paths(t.state_dir)):
                    continue
            self.core_of(name, _count_restore=False)

    # -- eviction ----------------------------------------------------------

    def evict(self, name: str) -> bool:
        """Seal ``name`` to a snapshot generation and drop its core.
        False when it is not evictable (default, already cold, or has
        replication attached); raises OSError when the seal itself
        fails — the tenant then STAYS resident (nothing was lost)."""
        with self._lock:
            t = self.get(name)
            if not t.evictable():
                return False
            core = t.core
            core.seal_snapshot()  # OSError propagates, core untouched
            core.close()
            t.core = None
            t.evictions += 1
            return True

    def priced_resident_nbytes(self) -> int:
        with self._lock:
            return sum(t.priced_nbytes()
                       for t in self._tenants.values())

    def maybe_evict_cold(self) -> list[str]:
        """The pressure valve, called after state-growing requests:
        while the governor reports memory pressure (or the resident
        count exceeds ``SHEEP_SERVE_MAX_RESIDENT``), seal-and-drop the
        coldest evictable tenant.  Returns the names evicted (empty
        almost always).  A failed seal stops the sweep — disk trouble
        must not cascade into a tenant massacre."""
        evicted: list[str] = []
        while True:
            with self._lock:
                over_count = (
                    self.max_resident is not None
                    and sum(1 for t in self._tenants.values()
                            if t.resident) > self.max_resident)
                if not over_count and not self.governor.mem_pressure():
                    return evicted
                victims = sorted(
                    (t for t in self._tenants.values() if t.evictable()),
                    key=lambda t: t.last_touch)
                if not victims:
                    return evicted
                try:
                    if not self.evict(victims[0].name):
                        return evicted
                except OSError:
                    return evicted
                evicted.append(victims[0].name)

    def close_all(self) -> None:
        with self._lock:
            for t in self._tenants.values():
                if t.core is not None:
                    t.core.close()
                    t.core = None
