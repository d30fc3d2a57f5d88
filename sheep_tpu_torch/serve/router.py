"""The router tier: consistent-hash tenants onto serve clusters.

One serve cluster answers for the graphs it hosts; a FLEET needs a tier
above the clusters that (1) maps tenant -> cluster without a config
push per tenant, (2) spreads reads over every replica instead of
hammering the leader, and (3) rides through failover without the client
noticing — the sharded-serving shape "Scalable Edge Partitioning"
(PAPERS.md) assumes of any partitioner claiming production scale.

**Placement** is a consistent-hash ring (:class:`HashRing`): each
cluster contributes ``vnodes`` sha1 points, a tenant id hashes to the
first point at-or-after it.  Adding a cluster moves ~1/N of tenants,
removing one moves only its own — no rendezvous table to version.

**Request handling** speaks the serve line grammar verbatim, so every
existing client (and ``nc``) works through the router unchanged:

  TENANT x     handled locally: selects the tenant AND the cluster for
               this connection (forwarded as the upstream selector when
               the proxied connection is opened).
  reads        PART / PARENT / SUBTREE / ECV / PING round-robin over
               the tenant's cluster members — leader and followers
               alike (the follower bounded-staleness refusal is typed,
               so a stale follower re-routes instead of lying).
  writes       INSERT / REPARTITION / SNAPSHOT / EVICT go to the
               cluster's current leader.
  STATS        pinned to the leader (the authoritative view).
  METRICS      answered by the router itself: the FLEET
               scrape — fan-in from every reachable cluster member
               with instance/cluster labels + derived fleet gauges
               (:meth:`Router.fleet_metrics`).
  ROUTER       answered by the router itself: per-router counters.
  MIGRATE      answered by the router itself: ``MIGRATE
               <tenant> <cluster> [wait=<s>]`` starts the live
               migration driver (serve/migrate.py) — snapshot
               bootstrap, delta stream, epoch-fenced cutover — and
               remaps the tenant when the cutover lands.

**Placement overrides**: a completed migration pins the
tenant to its new cluster in ``tenant-map.json`` (durable, tmp+fsync+
rename) — consulted before the ring, survives router restarts, and is
also learned reactively: a member answering ``ERR moved dest=<cid>``
teaches the router the new placement and the request is replayed there
(the fence refused it BEFORE applying, so the replay is epoch-safe —
first apply, not double apply).

**Trace context**: forwarded requests carry a ``RID=<hex>``
prefix token (adaptive — see :data:`RID_ENV`) so every process the
request crosses records joinable spans; ``sheep trace --merge``
stitches them.

**Failover contract** (the epoch-safe retry rule): a request that died
with a TYPED refusal was not applied — ``notleader`` re-resolves and
retries transparently, ``stale`` tries the next replica.  A connection
that died AFTER an INSERT was sent with no response is ambiguous: the
insert may be durable on the old leader's chain, so the router NEVER
re-sends it to a new epoch on its own — it answers ``ERR unavailable
... outcome unknown`` and the client (who owns idempotency) decides.
Reads are safely re-sent anywhere.  ``ERR unavailable``/``fenced``
responses re-resolve the leader before the next request.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time

from ..obs import trace
from ..obs.metrics import (Registry, parse_prometheus, relabel,
                           set_process_gauges)
from .cluster import find_leader, resolve_peer
from .protocol import (BadRequest, ServeClient, ServeError, err_line,
                       ok_kv, split_prefix_tokens)
from .tenants import DEFAULT_TENANT

CLUSTERS_ENV = "SHEEP_ROUTE_CLUSTERS"
VNODES_ENV = "SHEEP_ROUTE_VNODES"
#: trace-context stamping.  Unset (the default) is ADAPTIVE:
#: write verbs always carry a minted ``RID=`` token (the follower-fsync
#: attribution chain is the point, and a WAL fsync dwarfs the token),
#: while reads are stamped only when this router's own trace recorder
#: is live — a read's rid is only readable through the router's span,
#: so stamping it blind is pure wire+parse cost (PERF_NOTES r10).
#: "1" forces stamping on every request; "0" disables minting entirely
#: (client-sent RID= tokens always forward regardless).
RID_ENV = "SHEEP_ROUTE_RID"

ADDR_FILE = "router.addr"
#: durable tenant->cluster placement overrides (migration landings)
TENANT_MAP_FILE = "tenant-map.json"

#: reads that spread across every cluster member
SPREAD_VERBS = ("PART", "PARENT", "SUBTREE", "ECV", "PING")
#: verbs pinned to the tenant's cluster leader (METRICS is NOT here
#: anymore: the router answers it itself with the fleet scrape)
LEADER_VERBS = ("INSERT", "REPARTITION", "SNAPSHOT", "EVICT", "STATS")


class HashRing:
    """Consistent hashing of tenant ids onto cluster ids."""

    def __init__(self, cluster_ids, vnodes: int = 64):
        if not cluster_ids:
            raise ValueError("a ring needs at least one cluster")
        self.cluster_ids = list(cluster_ids)
        self.vnodes = vnodes
        points = []
        for cid in self.cluster_ids:
            for i in range(vnodes):
                points.append((self._hash(f"{cid}#{i}"), cid))
        points.sort()
        self._points = points

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha1(key.encode("utf-8")).digest()[:8], "big")

    def lookup(self, key: str) -> str:
        """The cluster id owning ``key``: first ring point at or after
        the key's hash (wrapping)."""
        h = self._hash(key)
        pts = self._points
        lo, hi = 0, len(pts)
        while lo < hi:
            mid = (lo + hi) // 2
            if pts[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return pts[lo % len(pts)][1]


def parse_clusters(spec: str) -> dict[str, list[str]]:
    """``[name@]peer,peer[;...]`` -> {cluster_id: [peer specs]}.
    Unnamed clusters get positional ids c0, c1, ... (stable for a fixed
    spec; name clusters explicitly if the set will grow)."""
    out: dict[str, list[str]] = {}
    for i, entry in enumerate(s for s in spec.split(";") if s.strip()):
        entry = entry.strip()
        name, sep, peers = entry.partition("@")
        if not sep:
            name, peers = f"c{i}", entry
        name = name.strip()
        plist = [p.strip() for p in peers.split(",") if p.strip()]
        if not name or not plist:
            raise ValueError(
                f"cluster entry {entry!r}: want [name@]peer,peer")
        if name in out:
            raise ValueError(f"cluster {name!r} named twice")
        out[name] = plist
    if not out:
        raise ValueError(f"no clusters in {spec!r}")
    return out


class _Upstream:
    """One proxied connection to one backend node, tenant-stamped."""

    __slots__ = ("client", "tenant")

    def __init__(self, client: ServeClient):
        self.client = client
        self.tenant = DEFAULT_TENANT


class _Cluster:
    """One serve cluster as the router sees it: peer specs, a cached
    leader, and a read-spread cursor."""

    #: how long an ``ERR diverged`` keeps a member out of the read
    #: spread before it is re-tried (heals are snapshot-sized; the
    #: member itself re-admits reads the moment its quarantine clears)
    DIVERGED_TTL_S = 5.0

    def __init__(self, cid: str, peers: list[str],
                 poll_timeout_s: float = 2.0):
        self.cid = cid
        self.peers = peers
        self.poll_timeout_s = poll_timeout_s
        self._leader: tuple[str, int] | None = None
        self._rr = 0
        self._lock = threading.Lock()
        self._diverged: dict[tuple[str, int], float] = {}

    def nodes(self) -> list[tuple[str, int]]:
        out = []
        for spec in self.peers:
            addr = resolve_peer(spec)
            if addr is not None and addr not in out:
                out.append(addr)
        return out

    def leader(self, refresh: bool = False) -> tuple[str, int] | None:
        with self._lock:
            if self._leader is not None and not refresh:
                return self._leader
        found = find_leader(self.peers, self.poll_timeout_s)
        addr = None
        if found is not None:
            host, _, port = found[0].rpartition(":")
            addr = (host, int(port))
        with self._lock:
            self._leader = addr
        return addr

    def set_leader_hint(self, hint: str) -> None:
        """``ERR notleader host:port`` carried the answer — use it."""
        host, _, port = hint.rpartition(":")
        try:
            addr = (host, int(port))
        except ValueError:
            return
        with self._lock:
            self._leader = addr

    def forget_leader(self) -> None:
        with self._lock:
            self._leader = None

    def mark_diverged(self, addr: tuple[str, int]) -> None:
        """A member answered ``ERR diverged``: keep it out
        of the read spread until the TTL lapses — every read it would
        get is a guaranteed refusal while it re-syncs."""
        with self._lock:
            self._diverged[addr] = time.monotonic() + self.DIVERGED_TTL_S

    def read_targets(self) -> list[tuple[str, int]]:
        """Cluster members, rotated one step per call — the read spread
        across followers AND leader; retries walk the rest of the
        list.  Members marked diverged are pushed to the BACK, not
        dropped: if every healthy member is unreachable they are still
        a typed answer, and their refusal re-confirms the mark."""
        nodes = self.nodes()
        if not nodes:
            return []
        now = time.monotonic()
        with self._lock:
            self._diverged = {a: t for a, t in self._diverged.items()
                              if t > now}
            bad = set(self._diverged)
            self._rr = (self._rr + 1) % len(nodes)
            k = self._rr
        rotated = nodes[k:] + nodes[:k]
        if not bad:
            return rotated
        return ([a for a in rotated if a not in bad]
                + [a for a in rotated if a in bad])


class Router:
    """The daemon: thread-per-connection proxy over the cluster map.

    Deliberately simpler than the serve daemon's selectors loop — the
    router holds no graph state, so a stalled connection costs one
    thread, not a tenant; and the bench measures it as its own process
    (pinned separately, scripts/servebench.py) so its cost never hides
    inside a daemon's numbers.
    """

    def __init__(self, clusters: dict[str, list[str]],
                 host: str = "127.0.0.1", port: int = 0,
                 state_dir: str | None = None, vnodes: int = 64,
                 retries: int = 4, poll_timeout_s: float = 2.0):
        self.clusters = {cid: _Cluster(cid, peers, poll_timeout_s)
                         for cid, peers in clusters.items()}
        self.ring = HashRing(sorted(self.clusters), vnodes=vnodes)
        self.host = host
        self.port = port
        self.state_dir = state_dir
        self.retries = retries
        self.poll_timeout_s = poll_timeout_s
        _rid_env = os.environ.get(RID_ENV, "")
        self.rid_enabled = _rid_env != "0"
        self.rid_always = _rid_env == "1"
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        self.counters = {"conns": 0, "requests": 0, "reads": 0,
                         "writes": 0, "retries": 0, "reroutes": 0,
                         "errors": 0, "insert_unknown": 0,
                         "scrapes": 0, "scrape_errors": 0,
                         "moved_reroutes": 0, "diverged_skips": 0}
        # the router's own registry: its counters + process
        # self-accounting ride the fleet scrape like any member's
        self.metrics = Registry()
        # live migration state: placement overrides beat the
        # ring, one driver per tenant, completion/abort tallies
        self._overrides: dict[str, str] = self._load_overrides()
        self._migrations: dict[str, object] = {}
        self.mig_completed = 0
        self.mig_aborted = 0
        # set by cli/route.py when SHEEP_REBALANCE=1
        self.rebalancer = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        assert self._listener is not None, "router not started"
        return self._listener.getsockname()[:2]

    def start(self) -> "Router":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self._listener.listen(128)
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
            h, p = self.address
            with open(os.path.join(self.state_dir, ADDR_FILE), "w") as f:
                f.write(f"{h} {p}\n")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="route-accept")
        self._accept_thread.start()
        self.resume_migrations()
        return self

    def run_forever(self) -> None:
        while not self._stop.wait(0.5):
            pass

    def shutdown(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            self.counters["conns"] += 1
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True, name="route-conn").start()

    # -- placement ---------------------------------------------------------

    def placement_of(self, tenant: str) -> str:
        """The cluster id owning ``tenant``: a migration override if one
        landed, the hash ring otherwise.  An override naming a cluster
        no longer in the map falls back to the ring (never KeyErrors a
        request)."""
        with self._lock:
            cid = self._overrides.get(tenant)
        if cid is not None and cid in self.clusters:
            return cid
        return self.ring.lookup(tenant)

    def cluster_for(self, tenant: str) -> _Cluster:
        return self.clusters[self.placement_of(tenant)]

    def cluster_by_id(self, cid: str) -> _Cluster | None:
        return self.clusters.get(cid)

    def remap(self, tenant: str, cid: str) -> None:
        """Atomically repoint ``tenant`` at ``cid`` — durable FIRST
        (tmp+fsync+rename of tenant-map.json), then the in-memory swap,
        so a kill -9 between the two re-reads the new placement instead
        of reviving the old one."""
        with self._lock:
            nxt = dict(self._overrides)
            nxt[tenant] = cid
            self._save_overrides(nxt)
            self._overrides = nxt

    def _overrides_path(self) -> str | None:
        if not self.state_dir:
            return None
        return os.path.join(self.state_dir, TENANT_MAP_FILE)

    def _load_overrides(self) -> dict[str, str]:
        path = self._overrides_path()
        if path is None:
            return {}
        try:
            with open(path) as f:
                rec = json.load(f)
            return {str(k): str(v) for k, v in rec.items()} \
                if isinstance(rec, dict) else {}
        except (OSError, ValueError):
            return {}

    def _save_overrides(self, recs: dict[str, str]) -> None:
        path = self._overrides_path()
        if path is None:
            return
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(recs, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            pass  # non-durable router: the remap still holds in memory

    # -- live migration -----------------------------------------

    def start_migration(self, tenant: str, dest: str):
        """Start (or report) the one in-flight migration for ``tenant``.
        Returns the Migration driver; raises ValueError on an unknown
        destination or a no-op (tenant already lives there)."""
        from .migrate import Migration
        if dest not in self.clusters:
            raise ValueError(f"unknown cluster {dest!r} (have: "
                             f"{'/'.join(sorted(self.clusters))})")
        with self._lock:
            cur = self._migrations.get(tenant)
            if cur is not None and not cur.done.is_set():
                return cur
        if self.placement_of(tenant) == dest:
            raise ValueError(f"tenant {tenant!r} already lives on "
                             f"{dest}")
        mig = Migration(self, tenant, dest)
        with self._lock:
            self._migrations[tenant] = mig
        return mig.start()

    def migration_finished(self, mig) -> None:
        """Driver completion callback (any terminal phase)."""
        with self._lock:
            if mig.phase == "done":
                self.mig_completed += 1
            elif mig.phase == "aborted":
                self.mig_aborted += 1

    def resume_migrations(self) -> list:
        """Restart every persisted, unfinished migration manifest —
        the kill -9'd router picks up where it stopped (every daemon-
        side MIG op is idempotent, so resuming is re-issuing)."""
        from .migrate import Migration, load_manifests
        out = []
        if not self.state_dir:
            return out
        for rec in load_manifests(self.state_dir):
            if rec.get("phase") in ("done", "aborted"):
                continue
            tenant, dest = rec["tenant"], rec.get("dest")
            if dest not in self.clusters:
                continue
            mig = Migration(self, tenant, dest, resume=rec)
            with self._lock:
                self._migrations[tenant] = mig
            out.append(mig.start())
        return out

    # -- one client connection ---------------------------------------------

    def _serve_conn(self, sock: socket.socket) -> None:
        upstreams: dict[tuple[str, int], _Upstream] = {}
        tenant = DEFAULT_TENANT
        try:
            rf = sock.makefile("rb")
            while not self._stop.is_set():
                raw = rf.readline()
                if not raw:
                    return
                try:
                    text = raw.decode("ascii").strip()
                except UnicodeDecodeError:
                    sock.sendall((err_line(
                        "badreq", "non-ascii request line") + "\n")
                        .encode("ascii"))
                    continue
                if not text:
                    continue
                self.counters["requests"] += 1
                # prefix-aware verb peek: DEADLINE=/RID=/unknown tokens
                # may precede the verb (protocol.split_prefix_tokens);
                # a malformed known token forwards as-is and gets the
                # upstream's typed badreq
                toks = text.split(None, 8)
                rid = None
                try:
                    _, rid, vi = split_prefix_tokens(toks)
                    verb = toks[vi].upper() if vi < len(toks) else ""
                except BadRequest:
                    verb, vi = toks[0].upper(), 0
                if verb == "QUIT":
                    sock.sendall(b"OK bye\n")
                    return
                if verb == "TENANT":
                    args = toks[vi + 1:] if vi + 1 <= len(toks) else []
                    tenant, resp = self._handle_tenant(
                        [verb] + args, tenant)
                    sock.sendall((resp + "\n").encode("ascii"))
                    continue
                if verb == "ROUTER":
                    sock.sendall((self._router_stats(tenant) + "\n")
                                 .encode("ascii"))
                    continue
                if verb == "MIGRATE":
                    args = toks[vi + 1:] if vi + 1 <= len(toks) else []
                    sock.sendall((self._handle_migrate(args) + "\n")
                                 .encode("ascii"))
                    continue
                if verb == "METRICS":
                    # the fleet scrape: fan-in from every
                    # reachable member, answered by the router itself
                    try:
                        body = self.fleet_metrics()
                    except Exception as exc:
                        sock.sendall((err_line(
                            "internal", f"fleet scrape failed: {exc}")
                            + "\n").encode("ascii"))
                        continue
                    sock.sendall(f"OK bytes={len(body)}\n"
                                 .encode("ascii") + body)
                    continue
                # stamp the trace context: a client-sent RID
                # wins; otherwise mint one so the whole fleet's spans
                # for this request share a join key.  Reads are gated on
                # the router's own recorder being live (RID_ENV note):
                # a read rid nobody can record is wire+parse for nothing
                fwd = text
                if rid is None and self.rid_enabled and verb and \
                        (verb not in SPREAD_VERBS or self.rid_always
                         or trace.enabled()):
                    rid = trace.new_rid()
                    fwd = f"RID={rid} {text}"
                with trace.rid_scope(rid):
                    with trace.sampled_span("route.req") as sp:
                        resp, payload = self._forward(fwd, verb, tenant,
                                                      upstreams)
                        sp.annotate(verb=verb, tenant=tenant,
                                    ok=resp[:2] == "OK")
                sock.sendall((resp + "\n").encode(
                    "ascii", errors="replace") + payload)
        except (OSError, ConnectionError):
            pass
        finally:
            for up in upstreams.values():
                try:
                    up.client.close()
                except Exception:
                    pass
            try:
                sock.close()
            except OSError:
                pass

    def _handle_tenant(self, toks, tenant) -> tuple[str, str]:
        args = toks[1:] if len(toks) > 1 else []
        if len(args) > 1:
            return tenant, err_line("badreq",
                                    "TENANT wants at most one name")
        if not args:
            return tenant, ok_kv(tenant=tenant)
        name = args[0]
        return name, ok_kv(tenant=name,
                           cluster=self.placement_of(name))

    def _router_stats(self, tenant: str) -> str:
        rec = dict(self.counters)
        rec["clusters"] = len(self.clusters)
        rec["tenant"] = tenant
        rec["cluster"] = self.placement_of(tenant)
        rec["migrations_completed"] = self.mig_completed
        rec["migrations_aborted"] = self.mig_aborted
        return ok_kv(**rec)

    def _handle_migrate(self, args) -> str:
        """``MIGRATE <tenant> <cluster> [wait=<s>]`` — kick the live
        migration driver.  Async by default (poll ROUTER / METRICS /
        MIG STAT); ``wait=`` blocks up to that many seconds and reports
        the phase it saw."""
        kv = {}
        pos = []
        for a in args:
            k, sep, v = a.partition("=")
            if sep:
                kv[k] = v
            else:
                pos.append(a)
        if len(pos) != 2:
            return err_line("badreq",
                            "MIGRATE wants <tenant> <cluster> "
                            "[wait=<s>]")
        tenant, dest = pos
        try:
            mig = self.start_migration(tenant, dest)
        except ValueError as exc:
            return err_line("badreq", str(exc))
        try:
            wait_s = float(kv.get("wait", "0") or 0)
        except ValueError:
            wait_s = 0.0
        if wait_s > 0:
            mig.done.wait(wait_s)
        rec = {"tenant": tenant, "src": mig.src, "dest": mig.dest,
               "phase": mig.phase}
        if mig.error:
            rec["error"] = mig.error.replace(" ", "_")[:120]
        return ok_kv(**rec)

    # -- the fleet scrape ---------------------------------------

    def fleet_metrics(self) -> bytes:
        """Fan-in ``METRICS`` from every reachable cluster member,
        stamp each sample with ``instance``/``cluster`` labels (tenant
        labels already ride the member series), derive the fleet gauges
        a dashboard wants (max repl lag and epoch skew per cluster,
        tenant residency counts, reachability), and prepend the
        router's own counters + process self-accounting.  One scrape of
        the router IS a scrape of the fleet."""
        t0 = time.monotonic()
        self.counters["scrapes"] += 1
        members: list[tuple[str, tuple[str, int]]] = []
        for cid, cluster in sorted(self.clusters.items()):
            for addr in cluster.nodes():
                members.append((cid, addr))
        bodies: dict[tuple, str | None] = {}
        lock = threading.Lock()

        def scrape(cid, addr):
            body = None
            try:
                with ServeClient(addr[0], addr[1],
                                 timeout_s=self.poll_timeout_s) as c:
                    body = c.metrics()
            except Exception:
                pass
            with lock:
                bodies[(cid, addr)] = body

        threads = [threading.Thread(target=scrape, args=m, daemon=True)
                   for m in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.poll_timeout_s * 2 + 5)

        per_cluster = {cid: {"ok": 0, "bad": 0, "lags": [], "epochs": []}
                       for cid in self.clusters}
        tenant_res: dict[str, int] = {}
        seen_headers: set = set()
        member_parts: list[str] = []
        for (cid, addr), body in sorted(bodies.items()):
            acc = per_cluster[cid]
            if body is None:
                acc["bad"] += 1
                self.counters["scrape_errors"] += 1
                continue
            acc["ok"] += 1
            for name, labels, val in parse_prometheus(body):
                if name == "sheep_serve_repl_lag_records" \
                        and not labels:
                    acc["lags"].append(val)
                elif name == "sheep_serve_epoch":
                    acc["epochs"].append(val)
                elif name == "sheep_serve_tenant_resident" and val >= 1:
                    tn = labels.get("tenant", "?")
                    tenant_res[tn] = tenant_res.get(tn, 0) + 1
            member_parts.append(relabel(
                body, {"cluster": cid, "instance":
                       f"{addr[0]}:{addr[1]}"}, seen_headers))

        m = self.metrics
        g = m.gauge
        for k, v in sorted(self.counters.items()):
            g(f"sheep_route_{k}", f"router {k} counter").set(v)
        g("sheep_route_clusters",
          "clusters behind this router").set(len(self.clusters))
        reach = g("sheep_fleet_members_reachable",
                  "members that answered this scrape, per cluster")
        unreach = g("sheep_fleet_members_unreachable",
                    "members that did not answer, per cluster")
        lagg = g("sheep_fleet_repl_lag_max_records",
                 "max replication lag across a cluster's members")
        skew = g("sheep_fleet_epoch_skew",
                 "max-min epoch across a cluster's members (nonzero = "
                 "a fenced straggler is still rejoining)")
        for cid, acc in sorted(per_cluster.items()):
            reach.labels(cluster=cid).set(acc["ok"])
            unreach.labels(cluster=cid).set(acc["bad"])
            lagg.labels(cluster=cid).set(max(acc["lags"], default=0))
            ep = acc["epochs"]
            skew.labels(cluster=cid).set(max(ep) - min(ep) if ep else 0)
        tres = g("sheep_fleet_tenant_resident_instances",
                 "instances holding the tenant resident in memory")
        for tn, n in sorted(tenant_res.items()):
            tres.labels(tenant=tn).set(n)
        # live migration telemetry
        with self._lock:
            migs = list(self._migrations.values())
            completed, aborted = self.mig_completed, self.mig_aborted
        inflight = [x for x in migs if not x.done.is_set()]
        g("sheep_migrate_inflight",
          "migrations currently in flight through this router").set(
            len(inflight))
        g("sheep_migrate_completed",
          "migrations that finished the epoch-fenced cutover").set(
            completed)
        g("sheep_migrate_aborted",
          "migrations aborted cleanly back to their source").set(
            aborted)
        dlag = g("sheep_migrate_delta_lag_records",
                 "records the migration target still trails its "
                 "source by (phase 2/3 drain)")
        for x in inflight:
            if x.last_lag is not None:
                dlag.labels(tenant=x.tenant).set(x.last_lag)
        rb = self.rebalancer
        if rb is not None:
            verd = g("sheep_rebalance_verdicts_total",
                     "rebalancer verdicts by action")
            for action, n in sorted(rb.verdict_counts.items()):
                verd.labels(action=action).set(n)
            g("sheep_rebalance_migrations_started",
              "migrations the rebalancer kicked off").set(
                rb.migrations_started)
        set_process_gauges(m, self.started_at)
        g("sheep_fleet_scrape_seconds",
          "wall cost of this fan-in scrape").set(
            round(time.monotonic() - t0, 6))
        h, p = self.address
        own = relabel(m.render(),
                      {"cluster": "router", "instance": f"{h}:{p}"},
                      seen_headers)
        return "".join([own] + member_parts).encode("ascii")

    # -- forwarding --------------------------------------------------------

    def _upstream(self, upstreams, addr, tenant) -> ServeClient:
        up = upstreams.get(addr)
        if up is None:
            up = _Upstream(ServeClient(addr[0], addr[1], timeout_s=30.0))
            upstreams[addr] = up
        if up.tenant != tenant:
            up.client._ok(f"TENANT {tenant}")  # ServeError propagates
            up.tenant = tenant
        return up.client

    def _drop(self, upstreams, addr) -> None:
        up = upstreams.pop(addr, None)
        if up is not None:
            try:
                up.client.close()
            except Exception:
                pass

    def _forward(self, text: str, verb: str, tenant: str,
                 upstreams) -> tuple[str, bytes]:
        """Route one request line; returns (response line, extra payload
        bytes) — the payload is only ever the METRICS scrape body."""
        is_read = verb in SPREAD_VERBS
        self.counters["reads" if is_read else "writes"] += 1
        last_err = "no reachable cluster member"
        for attempt in range(self.retries + 1):
            # re-resolved per attempt: an ``ERR moved`` mid-loop remaps
            # the tenant, and the replay must chase the new home
            cluster = self.cluster_for(tenant)
            if attempt:
                self.counters["retries"] += 1
            if is_read:
                targets = cluster.read_targets()
            else:
                leader = cluster.leader(refresh=attempt > 0)
                targets = [leader] if leader is not None else []
            if not targets:
                time.sleep(0.05 * attempt)
                continue
            for addr in targets if is_read else targets[:1]:
                try:
                    # connect + tenant-select: a failure HERE means the
                    # request was never sent — always safe to retry
                    client = self._upstream(upstreams, addr, tenant)
                except ServeError as exc:
                    last_err = f"{exc.code}: {exc.detail}"
                    self._drop(upstreams, addr)
                    continue
                except (OSError, ConnectionError) as exc:
                    self._drop(upstreams, addr)
                    last_err = f"{addr[0]}:{addr[1]} unreachable ({exc})"
                    if not is_read:
                        cluster.forget_leader()
                    continue
                try:
                    resp = client.request(text)
                except ServeError as exc:
                    last_err = f"{exc.code}: {exc.detail}"
                    self._drop(upstreams, addr)
                    continue
                except (OSError, ConnectionError) as exc:
                    self._drop(upstreams, addr)
                    last_err = f"connection to {addr[0]}:{addr[1]} " \
                               f"died mid-request ({exc})"
                    if verb == "INSERT":
                        # the epoch-safe rule (module docstring): an
                        # un-answered INSERT may be durable on the old
                        # chain — never re-sent to a new epoch by us
                        self.counters["insert_unknown"] += 1
                        cluster.forget_leader()
                        return (err_line(
                            "unavailable",
                            f"insert outcome unknown ({last_err}); "
                            f"not retried across failover - re-send "
                            f"only if idempotent for you"), b"")
                    cluster.forget_leader()
                    continue
                # a complete response line: decide retry vs passthrough
                if resp.startswith("ERR notleader"):
                    self.counters["reroutes"] += 1
                    hint = resp.split()[2] if len(resp.split()) > 2 \
                        else "-"
                    if hint != "-":
                        cluster.set_leader_hint(hint)
                    else:
                        cluster.forget_leader()
                    last_err = "notleader"
                    break  # next attempt re-resolves
                if resp.startswith("ERR moved"):
                    # the cutover fence: this tenant lives on
                    # another cluster now.  The fence refused BEFORE
                    # applying, so replaying the request — a write
                    # included — at the new home is a first apply, never
                    # a double one (the notleader retry shape).
                    self.counters["moved_reroutes"] += 1
                    dest = None
                    for tok in resp.split():
                        if tok.startswith("dest="):
                            dest = tok[5:]
                    if dest and dest in self.clusters \
                            and dest != cluster.cid:
                        self.remap(tenant, dest)
                        last_err = f"moved to {dest}"
                        break  # next attempt re-resolves the cluster
                    return resp, b""  # dest unknown: typed passthrough
                if resp.startswith("ERR stale") and is_read:
                    last_err = "stale replica"
                    continue  # typed, unanswered: next replica
                if resp.startswith("ERR diverged") and is_read:
                    # the quarantine refusal: typed and
                    # unanswered like stale, but ALSO remembered — the
                    # member refuses every read until its re-sync
                    # completes, so the spread stops offering it reads
                    self.counters["diverged_skips"] += 1
                    cluster.mark_diverged(addr)
                    last_err = "diverged replica (quarantined)"
                    continue
                if resp.startswith(("ERR fenced", "ERR unavailable")):
                    # surface typed (an INSERT here is durable-but-
                    # unacked territory: the client decides), but make
                    # the NEXT request re-resolve
                    cluster.forget_leader()
                    return resp, b""
                return resp, b""
        self.counters["errors"] += 1
        return err_line("unavailable",
                        f"cluster {cluster.cid} did not answer after "
                        f"{self.retries + 1} attempts ({last_err})"), b""
