"""The long-lived partition service: sockets around a ServeCore.

Thread shapes (a selector loop, not a thread per connection):
ONE ``selectors``-based I/O loop owns every socket — accept, non-blocking
reads, buffered non-blocking writes — and hands complete request lines to
a bounded worker pool.  One slow client can no longer stall anything: a
reader that sends bytes slowly only delays its own lines, a client that
stops draining responses fills its own bounded output buffer and is
disconnected, and replication peers are just more registered sockets on
the same loop.  Each connection still serializes its OWN requests (the
batching unit is the line; responses never reorder), but connections are
fully independent.

Request lifecycle (the order is the contract)::

    io loop: read line -> queue on the connection
    worker:  parse -> admission slot -> fault hooks (serve/faults:
             req/query/insert sites) -> deadline check -> dispatch
    io loop: flush the response

Admission holds its slot across the fault hooks on purpose: an injected
``slow``/``hang`` occupies capacity exactly like a real slow client, so
the shedding paths are exercised by the same plan grammar that kills the
process.  The deadline check runs AFTER the hooks — a handler that lost
its budget answers ``ERR timeout``, it does not answer late.

Replication (serve/replicate.py) rides the same loop: a follower's
``REPL HELLO`` converts its connection into a push stream owned by the
:class:`ReplicationHub`; inbound ACK/NACK/FENCED lines route straight to
the hub without touching admission.  Roles: a ``leader`` accepts writes
(each insert waits for ``repl_acks`` follower acknowledgements before
its OK when the cluster is configured — an acknowledged insert is on at
least that many replicas, which is what makes failover lossless); a
``follower`` serves reads with a bounded-staleness guarantee and
redirects writes with ``ERR notleader <addr>``.  Failover transitions
(serve/cluster.py) are epoch-fenced: promotion seals the boundary
durably before the first write, and a fenced ex-leader demotes instead
of split-braining.

Every insert is durable (WAL fsync) before its ``OK`` leaves the process;
a kill -9 anywhere in the lifecycle loses at most inserts that were never
acknowledged — the restart contract tests/test_serve.py and the tier-1
smoke enforce, now cluster-wide (tests/test_replicate.py).

Multi-tenancy (serve/tenants.py): the daemon hosts N tenant
cores behind this one loop.  A connection's ``TENANT <name>`` selector
re-points its verbs; every tenant gets its own admission slots and (on
a clustered daemon) its own replication hub/stream, and the hot read
verbs answer as single numpy gathers over the selected tenant's
arrays.  Election is quorum-voted (``REPL VOTE``, :meth:`ServeDaemon.
grant_vote`): one grant per epoch per voter, majority of reachable
peers to promote.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..obs.metrics import Registry
from ..resources.errors import ResourceError
from ..supervisor.heartbeat import HeartbeatWriter, maybe_start_from_env
from . import faults as serve_faults
from .admission import AdmissionController, AdmissionRefused
from .cluster import ClusterConfig, FailoverWatcher, find_leader
from ..obs import trace
from .protocol import (MAX_LINE, BadRequest, err_line, ok_kv, ok_line,
                       parse_kv_args, parse_request, parse_vids,
                       parse_vids_batch)
from .replicate import ReplicationHub, Replicator, payload_crc
from .scrub import ALLOW_CORRUPT_ENV
from .state import PARENT_ABSENT, PARENT_ROOT, ServeCore
from .tenants import DEFAULT_TENANT, Tenant, TenantManager, UnknownTenant

ADDR_FILE = "serve.addr"
HEARTBEAT_FILE = "serve.hb"
STATUS_FILE = "serve.status.json"

DEADLINE_ENV = "SHEEP_SERVE_DEADLINE_S"
MAX_INFLIGHT_ENV = "SHEEP_SERVE_MAX_INFLIGHT"
SNAP_EVERY_ENV = "SHEEP_SERVE_SNAP_EVERY"
DRIFT_ENV = "SHEEP_SERVE_DRIFT"
DRIFT_MIN_ENV = "SHEEP_SERVE_DRIFT_MIN"
#: the re-sequence family: master switch, sequence-drift
#: fraction, minimum inserts before the detector may fire, and the
#: degree-rank movement that counts an in-sequence insert as drifted
RESEQ_ENV = "SHEEP_RESEQ"
RESEQ_DRIFT_ENV = "SHEEP_RESEQ_DRIFT"
RESEQ_DRIFT_MIN_ENV = "SHEEP_RESEQ_DRIFT_MIN"
RESEQ_RANK_ENV = "SHEEP_RESEQ_RANK"
#: the leader group-commit window: the shared fsync is cut
#: when the group reaches MAX records or DELAY_S elapses with company; a
#: lone insert never waits (idle latency unchanged).  DELAY_S=0 keeps
#: pure piggybacking: whatever appended during the previous fsync forms
#: the next group.
GROUP_COMMIT_MAX_ENV = "SHEEP_SERVE_GROUP_COMMIT_MAX"
GROUP_COMMIT_DELAY_ENV = "SHEEP_SERVE_GROUP_COMMIT_DELAY_S"

#: a connection whose un-flushed responses exceed this is a slow
#: consumer and is closed (replication peers get snapshot-sized room)
OUTBUF_CAP = 8 << 20
#: per-connection queued-line backpressure: past this many undrained
#: requests the loop stops READING that connection until it catches up
PENDING_CAP = 256


@dataclass
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 0            # 0: ephemeral, discover via serve.addr
    deadline_s: float = 30.0
    max_inflight: int = 64
    snap_every: int = 256
    drift_frac: float = 0.1
    drift_min_cut: int = 64
    #: re-sequencing: the detector thresholds travel to the
    #: core (cli/serve.py's core_kw); ``reseq`` gates the background job
    reseq: bool = True
    reseq_frac: float = 0.25
    reseq_min: int = 256
    reseq_rank: int = 8
    #: leader group commit: records per shared fsync cap and
    #: the adaptive window a non-lone leader may stretch to fill it
    group_commit_max: int = 256
    group_commit_delay_s: float = 0.002
    #: anti-entropy: background artifact-scrub period in
    #: seconds (0 = off; the SCRUB verb still runs one inline)
    scrub_interval_s: float = 0.0
    read_only: bool = False
    #: ceiling on how long an injected hang may stall a handler
    hang_cap_s: float = 2.0
    events: list = field(default_factory=list)

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        kw: dict = {}
        if os.environ.get(DEADLINE_ENV):
            kw["deadline_s"] = float(os.environ[DEADLINE_ENV])
        if os.environ.get(MAX_INFLIGHT_ENV):
            kw["max_inflight"] = int(os.environ[MAX_INFLIGHT_ENV])
        if os.environ.get(SNAP_EVERY_ENV):
            kw["snap_every"] = int(os.environ[SNAP_EVERY_ENV])
        if os.environ.get(DRIFT_ENV):
            kw["drift_frac"] = float(os.environ[DRIFT_ENV])
        if os.environ.get(DRIFT_MIN_ENV):
            kw["drift_min_cut"] = int(os.environ[DRIFT_MIN_ENV])
        if os.environ.get(RESEQ_ENV):
            kw["reseq"] = os.environ[RESEQ_ENV] not in ("0", "no", "off")
        if os.environ.get(RESEQ_DRIFT_ENV):
            kw["reseq_frac"] = float(os.environ[RESEQ_DRIFT_ENV])
        if os.environ.get(RESEQ_DRIFT_MIN_ENV):
            kw["reseq_min"] = int(os.environ[RESEQ_DRIFT_MIN_ENV])
        if os.environ.get(RESEQ_RANK_ENV):
            kw["reseq_rank"] = int(os.environ[RESEQ_RANK_ENV])
        if os.environ.get(GROUP_COMMIT_MAX_ENV):
            kw["group_commit_max"] = int(os.environ[GROUP_COMMIT_MAX_ENV])
        if os.environ.get(GROUP_COMMIT_DELAY_ENV):
            kw["group_commit_delay_s"] = float(
                os.environ[GROUP_COMMIT_DELAY_ENV])
        from .scrub import scrub_interval_s
        kw["scrub_interval_s"] = scrub_interval_s()
        kw.update(overrides)
        return cls(**kw)


class _Conn:
    """One client on the I/O loop.  All mutable fields are guarded by
    the daemon's ``_io_lock`` except ``inbuf``, which only the loop
    thread touches."""

    __slots__ = ("sock", "inbuf", "outbuf", "pending", "busy", "repl",
                 "paused", "close_after_flush", "abort", "closed",
                 "outbuf_cap", "tenant", "hub")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.pending: deque = deque()
        self.busy = False          # a worker owns this conn's queue
        self.repl = False          # converted to a replication stream
        self.paused = False        # read interest dropped (backpressure)
        self.close_after_flush = False
        self.abort = False         # close NOW, drop unflushed bytes
        self.closed = False
        self.outbuf_cap = OUTBUF_CAP
        self.tenant = DEFAULT_TENANT  # connection-scoped TENANT selector
        self.hub = None            # the hub owning a repl stream conn


class ServeDaemon:
    """Selectors loop + worker pool + admission + deadlines + fault
    hooks + replication roles around one core."""

    def __init__(self, core: ServeCore, config: ServeConfig | None = None,
                 cluster: ClusterConfig | None = None,
                 tenants: TenantManager | None = None):
        self.core = core
        self.config = config or ServeConfig.from_env()
        self.cluster = cluster or ClusterConfig.from_env()
        self.role = self.cluster.role
        self.node_id = self.cluster.node_id  # finalized at bind
        # the tenant table: the default tenant IS this core;
        # a bare ServeDaemon(core) hosts exactly one tenant and speaks
        # the single-tenant grammar byte for byte
        self.tenants = tenants if tenants is not None \
            else TenantManager(core)
        self.admission = AdmissionController(
            max_inflight=self.config.max_inflight,
            governor=core.governor,
            read_only=self.config.read_only)
        # per-tenant admission: each tenant gets its own slot pool so a
        # hot tenant's burst sheds ITS load, not its neighbors'
        for name in self.tenants.names():
            t = self.tenants.get(name)
            if name == DEFAULT_TENANT:
                t.admission = self.admission
            elif t.admission is None:
                t.admission = AdmissionController(
                    max_inflight=self.config.max_inflight,
                    governor=core.governor,
                    read_only=self.config.read_only)
        self._listener: socket.socket | None = None
        self._sel: selectors.DefaultSelector | None = None
        self._wake_r: socket.socket | None = None
        self._wake_w: socket.socket | None = None
        self._io_thread: threading.Thread | None = None
        self._pool: ThreadPoolExecutor | None = None
        self._stop = threading.Event()
        self._io_lock = threading.Lock()
        self._conns: dict[int, _Conn] = {}
        self._dirty: set[int] = set()
        self._hb: HeartbeatWriter | None = None
        self._env_hb = None
        self._repartitioning = threading.Lock()
        self._resequencing = threading.Lock()
        self._role_lock = threading.RLock()
        self.started_at = time.monotonic()
        self._status_written = 0.0
        self.counters = {"requests": 0, "queries": 0, "inserts": 0,
                         "shed": 0, "timeouts": 0, "readonly": 0,
                         "errors": 0, "faults": 0, "notleader": 0,
                         "stale": 0, "repl_quorum_fails": 0, "moved": 0,
                         "diverged_reads": 0}
        # anti-entropy accounting: daemon-lifetime scrub
        # totals, exported via STATS + the sheep_scrub_* gauges
        self._scrubbing = threading.Lock()
        self._last_scrub = time.monotonic()
        self.scrub_totals = {"runs": 0, "checked": 0, "failed": 0,
                             "quarantined": 0, "repaired": 0,
                             "unrepaired": 0}
        # flight-recorder metrics: per-daemon registry so
        # in-process test clusters never share counters; exported raw
        # over the METRICS verb and summarized into STATS (per-verb
        # counts + p50/p99 come from THIS registry, one code path)
        self.metrics = Registry()
        self._m_requests = self.metrics.counter(
            "sheep_serve_requests_total", "requests by verb")
        self._m_latency = self.metrics.histogram(
            "sheep_serve_request_seconds", "request latency by verb")
        self._m_errors = self.metrics.counter(
            "sheep_serve_errors_total", "typed ERR responses by code")
        # per-tenant request accounting rides its OWN series so the
        # unlabeled series (and everything scraping it) is
        # untouched by multi-tenancy
        self._m_tenant_requests = self.metrics.counter(
            "sheep_serve_tenant_requests_total",
            "requests by tenant and verb")
        # per-tenant latency: `sheep top` renders a current
        # per-tenant p99 from this histogram's sliding window; the
        # per-verb series above stays the lifetime view scrapers built on
        self._m_tenant_latency = self.metrics.histogram(
            "sheep_serve_tenant_request_seconds",
            "request latency by tenant")
        self.hub = ReplicationHub(core, send=self._send_async,
                                  close=self._abort_async,
                                  hb_s=self.cluster.hb_s,
                                  on_fenced=self._on_fenced)
        self.tenants.get(DEFAULT_TENANT).hub = self.hub
        self.watcher: FailoverWatcher | None = None
        #: quorum-vote state: the newest (epoch, candidate)
        #: this node granted — one vote per epoch is what makes two
        #: same-epoch leaders impossible (serve/cluster.py)
        self._vote: tuple[int, str] | None = None
        self.votes_granted = 0
        self.votes_refused = 0

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        assert self._listener is not None, "daemon not started"
        return self._listener.getsockname()[:2]

    def start(self) -> "ServeDaemon":
        """Bind, publish the address, start beating, spawn the I/O loop
        and worker pool, join the cluster.  Returns self so tests can
        ``daemon = ServeDaemon(...).start()``."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.config.host, self.config.port))
        self._listener.listen(128)
        self._listener.setblocking(False)
        host, port = self.address
        if not self.node_id:
            self.node_id = f"{host}:{port}"
        # address discovery for scripts: plain tiny file, rewritten on
        # every start (ephemeral ports move across restarts)
        with open(os.path.join(self.core.state_dir, ADDR_FILE), "w") as f:
            f.write(f"{host} {port}\n")
        self._hb = HeartbeatWriter(
            os.path.join(self.core.state_dir, HEARTBEAT_FILE)).start()
        self._env_hb = maybe_start_from_env()  # supervisor-launched case

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wakeup")
        # spare threads past the slot budget so a request that will be
        # REFUSED by admission always finds a thread to refuse it on —
        # that is what keeps "ERR overload" prompt while hang-faulted
        # requests squat on their slots
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.max_inflight + 8,
            thread_name_prefix="serve-worker")
        self._io_thread = threading.Thread(target=self._io_loop,
                                           daemon=True, name="serve-io")
        self._io_thread.start()

        # every hosted tenant opens (or first-touch bootstraps) before
        # the cluster join: followers HELLO per tenant immediately, and
        # a leader must be able to answer those HELLOs
        self.tenants.open_all()

        if self.cluster.clustered:
            if self.role == "leader":
                # a returning ex-leader must discover its fencing BEFORE
                # accepting a single write (split-brain rejoin guard)
                other = find_leader(self.cluster.peers,
                                    self.cluster.poll_timeout_s,
                                    min_epoch=self.core.epoch + 1)
                if other is not None:
                    self.role = "follower"
                    self.config.events.append(
                        ("fenced_at_start",
                         int(other[1].get("epoch", 0))))
            if self.role == "follower":
                self._start_replicators()
            self.watcher = FailoverWatcher(self, self.cluster).start()
        # a kill -9 mid-quarantine left a durable marker:
        # restart into the quarantine — reads stay refused, and the
        # follower stream heals off the marker's recorded phase
        self._sweep_quarantine()
        # a kill -9 mid-re-sequence left a durable manifest: resume (or
        # cleanly abort) it now, in the background
        self._resume_pending_reseqs()
        self._write_status(force=True)
        return self

    def run_forever(self) -> None:
        """Block until :meth:`shutdown` (the CLI foreground mode)."""
        while not self._stop.wait(0.5):
            pass

    def shutdown(self) -> None:
        self._stop.set()
        self._wake()
        if self.watcher is not None:
            self.watcher.stop()
        for t in self._tenant_entries():
            if t.replicator is not None:
                t.replicator.stop()
                t.replicator = None
            if t.mig is not None:
                rep = t.mig.get("replicator")
                if rep is not None:
                    rep.stop()
                t.mig = None
            if t.hub is not None:
                t.hub.stop()
        if self._io_thread is not None:
            self._io_thread.join(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._hb is not None:
            self._hb.stop()
        if self._env_hb is not None:
            self._env_hb.stop()
        self._write_status(force=True)
        self.tenants.close_all()

    # -- cluster role transitions ------------------------------------------

    def _tenant_entries(self) -> list[Tenant]:
        return [self.tenants.get(n) for n in self.tenants.names()]

    @property
    def replicator(self) -> Replicator | None:
        """The DEFAULT tenant's replication stream — the one the
        cluster's liveness/staleness machinery keys on (named tenants
        ride their own streams to the same leader)."""
        return self.tenants.get(DEFAULT_TENANT).replicator

    def _hub_for(self, t: Tenant) -> ReplicationHub:
        """The tenant's leader-side hub, rebuilt if an evict/restore
        cycle replaced the core object underneath it (only possible
        with zero attached followers — tenants.Tenant.evictable)."""
        core = self.tenants.core_of(t.name)
        hub = t.hub
        if hub is None or hub.core is not core:
            if hub is not None:
                hub.stop()
            hub = ReplicationHub(core, send=self._send_async,
                                 close=self._abort_async,
                                 hb_s=self.cluster.hb_s,
                                 on_fenced=self._on_fenced)
            t.hub = hub
            if t.name == DEFAULT_TENANT:
                self.hub = hub
        return hub

    def _start_replicators(self) -> None:
        """One follower stream per hosted tenant, all discovering the
        same leader (the cluster is one unit; tenants are state dirs)."""
        for t in self._tenant_entries():
            if t.replicator is not None or t.mig is not None:
                continue
            try:
                core = self.tenants.core_of(t.name)
            except FileNotFoundError:
                # adopted-but-empty (kill -9 before the migration's
                # snapshot landed): the resumed migration re-bootstraps
                continue
            t.replicator = Replicator(
                core, self.node_id,
                self._discover_leader, hb_s=self.cluster.hb_s,
                events=self.config.events, tenant=t.name).start()

    def _discover_leader(self) -> tuple[str, int] | None:
        """Replication discovery: the reachable peer that is leader at
        our epoch or later (a stale-epoch claimant is ignored)."""
        found = find_leader(self.cluster.peers,
                            self.cluster.poll_timeout_s,
                            min_epoch=self.core.epoch)
        if found is None:
            return None
        host, _, port = found[0].rpartition(":")
        return host, int(port)

    def leader_addr(self) -> str:
        """Where writes should go, as ``host:port`` (``-`` unknown)."""
        if self.role == "leader":
            h, p = self.address
            return f"{h}:{p}"
        rep = self.replicator
        if rep is not None and rep.connected_to is not None:
            return f"{rep.connected_to[0]}:{rep.connected_to[1]}"
        return "-"

    def promote(self, new_epoch: int) -> None:
        """Epoch-fenced promotion (the election winner's side): stop
        following, seal the boundary DURABLY — on EVERY hosted tenant,
        evicted ones restored first, so the whole daemon changes term as
        one unit — only then start taking writes.  A failed seal on the
        default tenant leaves this node a follower."""
        with self._role_lock:
            if self.role == "leader" or self._stop.is_set():
                return
            for t in self._tenant_entries():
                if t.replicator is not None:
                    t.replicator.stop()
                    t.replicator = None
            # the default tenant's seal is the promotion gate; named
            # tenants follow (their cores adopt the same epoch — a
            # failed named seal is retried by the applier's epoch fence
            # when that tenant next streams)
            self.core.advance_epoch(new_epoch)
            for t in self._tenant_entries():
                if t.name == DEFAULT_TENANT or t.mig is not None:
                    continue
                try:
                    core = self.tenants.core_of(t.name)
                except FileNotFoundError:
                    continue  # adopted-but-empty (mid-migration adopt)
                if core.epoch < new_epoch:
                    try:
                        core.advance_epoch(new_epoch)
                    except OSError as exc:
                        self.config.events.append(
                            ("tenant_epoch_seal_failed",
                             f"{t.name}: {exc}"))
            self.role = "leader"
            self.config.events.append(("promote", new_epoch))
            self._write_status(force=True)

    def demote(self, leader_addr: str | None, fenced_by: int) -> None:
        """The fence: a later epoch exists, this node's term is over.
        Drop the follower streams (they must rediscover the real
        leader) and rejoin as a follower; any divergent unacknowledged
        tail is rolled back by snapshot re-sync on reconnect."""
        with self._role_lock:
            if self.role == "follower" or self._stop.is_set():
                return
            self.role = "follower"
            for t in self._tenant_entries():
                if t.hub is not None:
                    t.hub.disconnect_all()
            self.config.events.append(("demote", fenced_by))
            self._start_replicators()
            self._write_status(force=True)

    def _on_fenced(self, fenced_by: int) -> None:
        """Hub callback: a follower answered REPL FENCED — a later
        epoch exists even if no peer poll has seen it yet."""
        self.demote(None, fenced_by)

    def grant_vote(self, epoch: int, candidate: str, seqno: int) -> bool:
        """The voter's half of the quorum-vote election
        (closing the symmetric-partition hole): grant at most ONE
        candidate per epoch, and only when this node has itself lost
        its leader — so two candidates that share any voter can never
        both promote into the same epoch.  Refusals:

          - I am a live leader (the candidate should fence on me), or
            the proposed epoch does not advance mine;
          - my replication stream is FRESH (a leader is alive from
            where I stand; the candidate is partitioned, not bereaved);
          - the candidate has not applied everything I have (electing
            it would lose acknowledged inserts);
          - I already voted for a different candidate at this or a
            later epoch.
        """
        with self._role_lock:
            ok = True
            if self.role == "leader" or epoch <= self.core.epoch:
                ok = False
            elif seqno < self.core.applied_seqno:
                ok = False
            else:
                rep = self.replicator
                age = rep.stream_age_s() if rep is not None else None
                if age is not None and age <= self.cluster.failover_s:
                    ok = False
                elif self._vote is not None:
                    ve, vc = self._vote
                    if ve > epoch or (ve == epoch and vc != candidate):
                        ok = False
            if ok:
                self._vote = (epoch, candidate)
                self.votes_granted += 1
                self.config.events.append(
                    ("vote_granted", epoch, candidate))
            else:
                self.votes_refused += 1
            return ok

    # -- the I/O loop ------------------------------------------------------

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except (OSError, AttributeError):
            pass

    def _send_async(self, conn: _Conn, data: bytes) -> bool:
        """Queue bytes for one connection (any thread).  False = the
        connection is gone or over its buffer cap (slow consumer)."""
        with self._io_lock:
            if conn.closed or conn.abort:
                return False
            if len(conn.outbuf) + len(data) > conn.outbuf_cap:
                conn.abort = True  # slow consumer: cut it loose
                self._dirty.add(id(conn))
                self._wake()
                return False
            conn.outbuf.extend(data)
            self._dirty.add(id(conn))
        self._wake()
        return True

    def _abort_async(self, conn: _Conn) -> None:
        with self._io_lock:
            conn.abort = True
            self._dirty.add(id(conn))
        self._wake()

    def _io_loop(self) -> None:
        sel = self._sel
        while not self._stop.is_set():
            try:
                events = sel.select(0.2)
            except OSError:
                break
            for key, mask in events:
                if key.data == "accept":
                    self._accept()
                elif key.data == "wakeup":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except OSError:
                        pass
                else:
                    conn: _Conn = key.data
                    if mask & selectors.EVENT_READ:
                        self._on_readable(conn)
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._on_writable(conn)
            self._apply_dirty()
            self._write_status()
            self._maybe_background_scrub()
        # shutdown: close everything the loop owns
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        try:
            sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, socket.timeout):
                return
            except OSError:
                return
            sock.setblocking(False)
            conn = _Conn(sock)
            self._conns[id(conn)] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _interest(self, conn: _Conn) -> int:
        ev = 0
        if not conn.paused and not conn.close_after_flush:
            ev |= selectors.EVENT_READ
        if conn.outbuf:
            ev |= selectors.EVENT_WRITE
        return ev

    def _apply_dirty(self) -> None:
        """Fold worker-thread state changes (queued bytes, aborts,
        pauses) into selector interests — only the loop thread touches
        the selector."""
        with self._io_lock:
            dirty = [self._conns.get(cid) for cid in self._dirty]
            self._dirty.clear()
        for conn in dirty:
            if conn is None or conn.closed:
                continue
            if conn.abort:
                self._close_conn(conn)
                continue
            ev = self._interest(conn)
            try:
                if ev:
                    self._sel.modify(conn.sock, ev, conn)
                else:
                    self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass

    def _close_conn(self, conn: _Conn) -> None:
        with self._io_lock:
            if conn.closed:
                return
            conn.closed = True
            self._conns.pop(id(conn), None)
        if conn.repl:
            (conn.hub or self.hub).detach(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            # client went away; flush what it is owed, then close
            if conn.outbuf:
                conn.close_after_flush = True
                self._update_interest(conn)
            else:
                self._close_conn(conn)
            return
        conn.inbuf.extend(data)
        if len(conn.inbuf) > MAX_LINE and b"\n" not in conn.inbuf:
            self._send_async(conn, (err_line(
                "badreq", f"request line exceeds {MAX_LINE} bytes")
                + "\n").encode("ascii"))
            conn.close_after_flush = True
            conn.inbuf.clear()
            self._update_interest(conn)
            return
        submit = False
        while True:
            nl = conn.inbuf.find(b"\n")
            if nl < 0:
                break
            raw = bytes(conn.inbuf[:nl])
            del conn.inbuf[: nl + 1]
            if len(raw) > MAX_LINE:
                self._send_async(conn, (err_line(
                    "badreq", f"request line exceeds {MAX_LINE} bytes")
                    + "\n").encode("ascii"))
                conn.close_after_flush = True
                break
            if conn.repl:
                # stream connection: ACK/NACK/FENCED go straight to the
                # hub that owns this stream (one hub per tenant) —
                # never through admission, never to the pool
                try:
                    (conn.hub or self.hub).on_line(
                        conn, raw.decode("ascii").strip())
                except UnicodeDecodeError:
                    pass
                continue
            with self._io_lock:
                conn.pending.append(raw)
                if not conn.busy:
                    conn.busy = True
                    submit = True
                if len(conn.pending) > PENDING_CAP:
                    conn.paused = True  # backpressure: stop reading
        self._update_interest(conn)
        if submit:
            self._pool.submit(self._drain, conn)

    def _update_interest(self, conn: _Conn) -> None:
        if conn.closed:
            return
        ev = self._interest(conn)
        try:
            if ev:
                self._sel.modify(conn.sock, ev, conn)
            else:
                self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass

    def _on_writable(self, conn: _Conn) -> None:
        with self._io_lock:
            buf = bytes(conn.outbuf)
        if buf:
            try:
                sent = conn.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn(conn)
                return
            with self._io_lock:
                del conn.outbuf[:sent]
                drained = not conn.outbuf
        else:
            drained = True
        if drained and conn.close_after_flush:
            self._close_conn(conn)
        else:
            self._update_interest(conn)

    # -- worker side -------------------------------------------------------

    def _drain(self, conn: _Conn) -> None:
        """Serialize one connection's queued lines (a pool worker owns
        the queue until it runs dry — responses never reorder within a
        connection, and other connections drain on other workers)."""
        while True:
            with self._io_lock:
                if conn.closed or conn.abort or not conn.pending:
                    conn.busy = False
                    return
                raw = conn.pending.popleft()
                if conn.paused and len(conn.pending) <= PENDING_CAP // 2:
                    conn.paused = False
                    self._dirty.add(id(conn))
                    self._wake()
            try:
                text = raw.decode("ascii").strip()
            except UnicodeDecodeError:
                self._send_async(conn, (err_line(
                    "badreq", "non-ascii request line") + "\n")
                    .encode("ascii"))
                continue
            if not text:
                continue
            if text[:5].upper() in ("REPL ", "REPL"):
                if self._handle_repl(conn, text):
                    # the connection now belongs to the hub
                    with self._io_lock:
                        conn.busy = False
                    return
                continue
            resp, close = self._handle_request(text, conn)
            alive = self._send_async(conn, (resp + "\n").encode("ascii"))
            if close:
                with self._io_lock:
                    conn.close_after_flush = True
                    self._dirty.add(id(conn))
                self._wake()
            if not alive or close:
                with self._io_lock:
                    conn.busy = False
                return

    # -- replication handshakes --------------------------------------------

    def _handle_repl(self, conn: _Conn, text: str) -> bool:
        """One ``REPL ...`` line on a line-mode connection.  Returns
        True when the connection was converted to a stream (the caller
        stops draining it)."""
        toks = text.split()
        sub = toks[1].upper() if len(toks) > 1 else ""
        try:
            if sub == "HELLO":
                return self._repl_hello(conn, toks[2:])
            if sub == "SNAPSHOT":
                self._repl_snapshot(conn, toks[2:])
                return False
            if sub == "VOTE":
                self._repl_vote(conn, toks[2:])
                return False
            self._send_async(conn, (err_line(
                "badrepl", f"unknown replication request {sub!r}")
                + "\n").encode("ascii"))
        except (BadRequest, ValueError) as exc:
            self._send_async(conn, (err_line("badrepl", str(exc)) + "\n")
                             .encode("ascii"))
        except ResourceError as exc:
            self._send_async(conn, (err_line("unavailable", str(exc))
                                    + "\n").encode("ascii"))
        return False

    def _repl_hello(self, conn: _Conn, args: list[str]) -> bool:
        kv = parse_kv_args(args)
        node = kv.get("node", "?")
        epoch = int(kv.get("epoch", 0))
        seqno = int(kv.get("seqno", 0))
        sig = kv.get("sig", "-")
        tname = kv.get("tenant", DEFAULT_TENANT)
        if self.role != "leader":
            self.counters["notleader"] += 1
            self._send_async(conn, (err_line(
                "notleader", self.leader_addr()) + "\n").encode("ascii"))
            return False
        try:
            tenant = self.tenants.get(tname)
        except UnknownTenant as exc:
            self._send_async(conn, (err_line("badrepl", exc.message)
                                    + "\n").encode("ascii"))
            return False
        hub = self._hub_for(tenant)
        core = hub.core
        reseq_behind = False
        if sig != "-" and sig != core.sig:
            # a sig the reseq manifest chains is a follower one or more
            # sequence generations BEHIND us — it adopts our
            # snapshot; a sig the chain has never seen is a foreign
            # build input and is refused exactly as before
            from .reseq import chain_has_sig
            if core.state_dir and chain_has_sig(core.state_dir, sig):
                reseq_behind = True
            else:
                self._send_async(conn, (err_line(
                    "badrepl", f"replica belongs to a different build "
                    f"input (sig {sig[:12]}..., ours {core.sig[:12]}...)")
                    + "\n").encode("ascii"))
                return False
        if epoch > core.epoch:
            # the caller lives in a later term than we do: we are the
            # stale one.  Refuse typed and let the fence check demote us.
            self._send_async(conn, (err_line(
                "fenced", f"epoch={core.epoch}") + "\n").encode("ascii"))
            self.config.events.append(("fence_hint", epoch))
            return False
        # stream iff the replica's position is inside our retention
        # window AND (same epoch, or at/before the promotion boundary —
        # past it an old-epoch replica may carry a divergent tail)
        can_stream = (not reseq_behind
                      and core.records_from(seqno) is not None
                      and seqno <= core.applied_seqno
                      and (epoch == core.epoch
                           or seqno <= core.epoch_base))
        if can_stream:
            self._send_async(conn, (ok_kv(
                mode="stream", epoch=core.epoch,
                seqno=core.applied_seqno) + "\n").encode("ascii"))
            from_seqno = seqno
        else:
            blob, snap_seqno, snap_epoch = core.snapshot_bytes()
            with self._io_lock:
                conn.outbuf_cap = max(conn.outbuf_cap,
                                      len(blob) + OUTBUF_CAP)
            header = ok_kv(mode="snapshot", bytes=len(blob),
                           seqno=snap_seqno, epoch=snap_epoch,
                           crc=payload_crc(blob)) + "\n"
            if not self._send_async(conn,
                                    header.encode("ascii") + blob):
                return False
            from_seqno = snap_seqno
        with self._io_lock:
            conn.repl = True
            conn.hub = hub
            # re-queue any lines the client pipelined behind HELLO so
            # the hub sees them (normally none)
            leftover = list(conn.pending)
            conn.pending.clear()
        for raw in leftover:
            try:
                hub.on_line(conn, raw.decode("ascii").strip())
            except UnicodeDecodeError:
                pass
        # a migration delta stream files its APPENDs under
        # the mdelta netfault site so the migration wire sweeps
        # independently of ordinary replication
        site = "mdelta" if kv.get("mig") else "repl"
        # anti-entropy capability: only a follower that said
        # verify=1 gets VERIFY frames — an old follower's parser never
        # sees a kind it cannot name, and the leader only pays the
        # state_crc capture when at least one verifying follower exists
        verify = bool(kv.get("verify")) and not kv.get("mig")
        if verify:
            from .scrub import verify_cadence
            core.enable_verify(verify_cadence())
        hub.attach(conn, node, from_seqno, site=site, verify=verify)
        self.config.events.append(("repl_attach", f"{node}:{tname}"
                                   if tname != DEFAULT_TENANT else node))
        return True

    def _repl_snapshot(self, conn: _Conn, args: list[str]) -> None:
        """Bootstrap fetch: one snapshot blob, connection stays
        line-mode (the follower opens its stream separately)."""
        kv = parse_kv_args(args)
        tname = kv.get("tenant", DEFAULT_TENANT)
        try:
            core = self.tenants.core_of(tname)
        except UnknownTenant as exc:
            self._send_async(conn, (err_line("badrepl", exc.message)
                                    + "\n").encode("ascii"))
            return
        blob, seqno, epoch = core.snapshot_bytes()
        with self._io_lock:
            conn.outbuf_cap = max(conn.outbuf_cap, len(blob) + OUTBUF_CAP)
        header = ok_kv(bytes=len(blob), seqno=seqno, epoch=epoch,
                       crc=payload_crc(blob), sig=core.sig) + "\n"
        self._send_async(conn, header.encode("ascii") + blob)

    def _repl_vote(self, conn: _Conn, args: list[str]) -> None:
        """``REPL VOTE epoch=E candidate=C seqno=S`` — the election
        quorum's ballot (serve/cluster.py requests these before a
        candidate may promote).  Line-mode, never converts the
        connection."""
        kv = parse_kv_args(args)
        try:
            epoch = int(kv["epoch"])
            seqno = int(kv["seqno"])
            candidate = kv["candidate"]
        except (KeyError, ValueError):
            raise BadRequest(
                "VOTE wants epoch=<int> candidate=<id> seqno=<int>")
        granted = self.grant_vote(epoch, candidate, seqno)
        self._send_async(conn, (ok_kv(
            grant=int(granted), epoch=self.core.epoch,
            node=self.node_id) + "\n").encode("ascii"))

    # -- request lifecycle -------------------------------------------------

    def _handle_request(self, text: str,
                        conn: _Conn | None = None) -> tuple[str, bool]:
        """One request -> (response, close?), with the registry fed:
        per-verb request counter + latency histogram (observed whatever
        the outcome — a shed or timed-out request is latency a client
        saw), ERR counter by code, and the per-tenant series.  A
        sampled ``serve.req`` span (SHEEP_TRACE_SAMPLE, obs/trace.py)
        wraps the whole thing so traces exist under load inside the
        <2% overhead budget; the request's RID= token scopes
        the whole handling, so the span AND every downstream span it
        opens (WAL fsync, snapshot seal) carry the rid — including when
        the sampler skips the serve.req span itself."""
        t0 = time.monotonic()
        tname = conn.tenant if conn is not None else DEFAULT_TENANT
        try:
            req = parse_request(text)
        except BadRequest as exc:
            self.counters["requests"] += 1
            self.counters["errors"] += 1
            resp, close = err_line("badreq", str(exc)), False
            verb = "BAD"  # unparseable lines don't mint verb series
        else:
            verb = req.verb
            with trace.rid_scope(req.rid):
                with trace.sampled_span("serve.req") as sp:
                    resp, close = self._handle_one(req, conn, t0)
                    if resp.startswith("ERR badreq"):
                        verb = "BAD"  # bad requests don't mint series
                    sp.annotate(verb=verb, tenant=tname,
                                ok=resp[:2] == "OK")
        self._m_requests.labels(verb=verb).inc()
        dur = time.monotonic() - t0
        self._m_latency.labels(verb=verb).observe(dur)
        self._m_tenant_requests.labels(tenant=tname, verb=verb).inc()
        self._m_tenant_latency.labels(tenant=tname).observe(dur)
        if resp.startswith("ERR "):
            code = resp.split(None, 2)[1]
            self._m_errors.labels(code=code).inc()
        return resp, close

    def _handle_one(self, req, conn: _Conn | None = None,
                    t0: float | None = None) -> tuple[str, bool]:
        """One parsed request -> (response line, close-connection?)."""
        self.counters["requests"] += 1
        if t0 is None:
            t0 = time.monotonic()
        budget = req.deadline_s if req.deadline_s is not None \
            else self.config.deadline_s
        deadline = t0 + budget
        kind = req.kind
        self.counters["inserts" if kind == "insert" else "queries"] += 1
        if req.verb == "TENANT":
            # the connection-scoped selector: touches no tenant state,
            # so it never holds (or is refused) an admission slot
            return self._handle_tenant(req, conn)
        try:
            tenant = self.tenants.get(
                conn.tenant if conn is not None else DEFAULT_TENANT)
        except UnknownTenant as exc:
            self.counters["errors"] += 1
            return err_line("notfound", exc.message), False
        try:
            with (tenant.admission or self.admission).admit(kind):
                # fault hooks run INSIDE admission: an injected hang/slow
                # occupies a slot exactly like a real slow client
                hang = max(0.0, min(deadline - time.monotonic() + 0.05,
                                    self.config.hang_cap_s))
                if serve_faults.fire("req", hang_s=hang):
                    self.counters["faults"] += 1
                if serve_faults.fire(kind, hang_s=hang):
                    self.counters["faults"] += 1
                if time.monotonic() > deadline:
                    self.counters["timeouts"] += 1
                    return err_line(
                        "timeout",
                        f"request exceeded its {budget:g}s deadline "
                        f"before dispatch"), False
                return self._dispatch(req, deadline, tenant)
        except BadRequest as exc:
            # argument-level parse errors surface from dispatch
            self.counters["errors"] += 1
            return err_line("badreq", str(exc)), False
        except AdmissionRefused as exc:
            if exc.code == "readonly":
                self.counters["readonly"] += 1
            else:
                self.counters["shed"] += 1
            return err_line(exc.code, str(exc)), False
        except ResourceError as exc:
            # WAL append / snapshot refused by the environment: typed,
            # nothing acknowledged, daemon keeps serving
            self.counters["errors"] += 1
            return err_line("unavailable", str(exc)), False
        except serve_faults.ServeKilled:
            raise
        except Exception as exc:  # the one place "internal" is honest
            self.counters["errors"] += 1
            print(f"serve: internal error on {req.verb} "
                  f"{' '.join(req.args[:8])!r}: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr,
                  flush=True)
            return err_line("internal", f"{type(exc).__name__}: {exc}"), \
                False

    def _handle_tenant(self, req, conn: _Conn | None) -> tuple[str, bool]:
        """``TENANT`` -> current selection; ``TENANT <name>`` re-points
        THIS connection at another hosted tenant (the default grammar
        is untouched for connections that never select)."""
        cur = conn.tenant if conn is not None else DEFAULT_TENANT
        if not req.args:
            return ok_kv(tenant=cur), False
        if len(req.args) != 1:
            raise BadRequest("TENANT wants at most one tenant name")
        name = req.args[0]
        try:
            self.tenants.get(name)
        except UnknownTenant as exc:
            self.counters["errors"] += 1
            return err_line("notfound", exc.message), False
        if conn is not None:
            conn.tenant = name
        return ok_kv(tenant=name), False

    def _check_staleness(self, tenant: Tenant) -> str | None:
        """Follower bounded-staleness guarantee: None = fresh enough to
        answer, else the typed refusal line."""
        if self.role != "follower" or self.cluster.max_lag is None:
            return None
        rep = tenant.replicator
        lag = rep.lag if rep is not None else 0
        if rep is None or rep.connected_to is None:
            lag = max(lag, 1)  # disconnected: staleness is unbounded
        if lag > self.cluster.max_lag:
            self.counters["stale"] += 1
            return err_line(
                "stale", f"lag={lag} exceeds the {self.cluster.max_lag}-"
                f"record staleness bound; retry or read the leader")
        return None

    def _dispatch(self, req, deadline: float,
                  tenant: Tenant) -> tuple[str, bool]:
        verb = req.verb
        # verbs that never touch tenant state run BEFORE the core
        # resolves — a PING or an EVICT must not thaw a cold tenant
        if verb == "PING":
            return ok_line("pong"), False
        if verb == "QUIT":
            return ok_line("bye"), True
        if verb == "EVICT":
            return self._handle_evict(req), False
        if verb == "MIG":
            # migration plumbing names its tenant in args and must work
            # on fenced tenants (STAT/UNSEAL are how a fence is
            # inspected and lifted), so it runs before the moved check
            return self._handle_mig(req), False
        if tenant.moved_dest is not None:
            # the cutover fence: this tenant lives elsewhere
            # now.  A typed refusal naming the new home — NEVER a
            # silent drop, and never a write applied here — is what
            # lets the router re-resolve and replay in-flight requests
            # epoch-safely with zero acked-insert loss.
            self.counters["moved"] += 1
            return err_line("moved", f"dest={tenant.moved_dest}"), False
        core = self.tenants.core_of(tenant.name)
        if verb in ("PART", "PARENT", "SUBTREE", "ECV"):
            # the quarantine read gate: a replica whose state
            # diverged from the leader's refuses every read with a typed
            # error until the re-sync proves it crc-equal again — a
            # wrong answer served fast is still a wrong answer
            if getattr(core, "quarantined", False):
                self.counters["diverged_reads"] += 1
                return err_line(
                    "diverged",
                    "replica state diverged from the leader "
                    "(quarantined); re-sync in progress - read another "
                    "replica or the leader"), False
            stale = self._check_staleness(tenant)
            if stale is not None:
                return stale, False
        # the vectorized hot verbs: one numpy parse + one
        # gather + one join per batch, byte-identical to the scalar loop
        if verb == "PART":
            vids = parse_vids_batch(req.args)
            return "OK " + core.part_tokens(vids), False
        if verb == "PARENT":
            vids = parse_vids_batch(req.args)
            res = core.parent_batch(vids).tolist()
            return "OK " + " ".join(
                "absent" if r == PARENT_ABSENT
                else "root" if r == PARENT_ROOT else str(r)
                for r in res), False
        if verb == "SUBTREE":
            vids = parse_vids_batch(req.args)
            if len(vids) == 1:
                # the single-vid grammar, byte for byte (kv form,
                # typed notfound); batches answer positionally instead
                st = core.subtree(int(vids[0]))
                if st is None:
                    return err_line(
                        "notfound",
                        f"vertex {int(vids[0])} is not in the "
                        f"sequence"), False
                return ok_kv(size=st[0], pst=st[1]), False
            sizes, psts = core.subtree_batch(vids)
            return "OK " + " ".join(
                "absent" if s < 0 else f"{s}:{w}"
                for s, w in zip(sizes.tolist(), psts.tolist())), False
        if verb == "ECV":
            try:
                return ok_kv(**core.ecv()), False
            except RuntimeError as exc:
                return err_line("unavailable", str(exc)), False
        if verb == "STATS":
            return self._stats_line(tenant), False
        if verb == "METRICS":
            return self._metrics_response(), False
        if verb == "CRC":
            # the anti-entropy comparison point: state_crc at
            # the applied seqno — O(state) per call, deliberately its
            # own verb so STATS polling never pays it
            return ok_kv(crc=core.state_crc(),
                         seqno=core.applied_seqno,
                         epoch=core.epoch), False
        if verb == "INSERT":
            if self.role != "leader":
                self.counters["notleader"] += 1
                return err_line("notleader", self.leader_addr()), False
            if tenant.mig is not None:
                # a tenant still migrating IN holds the source's epoch;
                # accepting a write here before the cutover's epoch
                # advance would dual-own the tenant in the same epoch
                return err_line(
                    "unavailable",
                    f"tenant {tenant.name} is migrating in "
                    f"(phase={tenant.mig.get('phase', '?')}); writes "
                    f"open after the epoch-fenced cutover"), False
            vids = parse_vids(req.args, want_pairs=True)
            pairs = [(vids[i], vids[i + 1])
                     for i in range(0, len(vids), 2)]
            import numpy as np
            seqno = core.insert(np.asarray(pairs, dtype=np.uint32),
                                rid=req.rid)
            if self.cluster.clustered and self.cluster.repl_acks > 0:
                # the replication quorum: the OK means this insert is
                # durable on repl_acks followers too, so failover to the
                # best-caught-up replica cannot lose it
                left = max(0.05, deadline - time.monotonic())
                hub = self._hub_for(tenant)
                if not hub.wait_acks(seqno, self.cluster.repl_acks,
                                     left):
                    self.counters["repl_quorum_fails"] += 1
                    return err_line(
                        "unavailable",
                        f"replication quorum not reached (need "
                        f"{self.cluster.repl_acks} follower ack(s) for "
                        f"seqno {seqno}); the insert is durable locally "
                        f"and will replicate, but is NOT acknowledged"), \
                        False
            self._maybe_background_repartition(core)
            self._maybe_background_reseq(core, self._hub_for(tenant))
            self.tenants.maybe_evict_cold()
            return ok_kv(seq=seqno, applied=len(pairs)), False
        if verb == "SNAPSHOT":
            path = core.seal_snapshot()
            return ok_kv(snap=os.path.basename(path)), False
        if verb == "REPARTITION":
            if self.role != "leader":
                self.counters["notleader"] += 1
                return err_line("notleader", self.leader_addr()), False
            return ok_kv(**core.repartition()), False
        if verb == "RESEQ":
            # the operator's forced re-sequence: runs the
            # full crash-safe job inline — pricing skipped (force), swap
            # announced to followers.  One at a time daemon-wide, same
            # rationing as REPARTITION's background trigger.
            if self.role != "leader":
                self.counters["notleader"] += 1
                return err_line("notleader", self.leader_addr()), False
            if not self._resequencing.acquire(blocking=False):
                return err_line("unavailable",
                                "a re-sequence is already running"), False
            try:
                from .reseq import run_reseq
                res = run_reseq(core, force=True,
                                hub=self._hub_for(tenant),
                                events=self.config.events)
            finally:
                self._resequencing.release()
            res.pop("plan", None)  # kv lines carry scalars only
            return ok_kv(**res), False
        if verb == "SCRUB":
            # the operator's forced anti-entropy pass: one
            # inline scrub over this tenant's sealed artifacts — pricing
            # skipped (force), one at a time daemon-wide like RESEQ
            if not core.state_dir:
                return err_line("unavailable",
                                "tenant has no state dir to scrub"), False
            if not self._scrubbing.acquire(blocking=False):
                return err_line("unavailable",
                                "a scrub is already running"), False
            try:
                counts = self._scrub_tenant(tenant, core)
            finally:
                self._scrubbing.release()
            counts.pop("events", None)  # kv lines carry scalars only
            return ok_kv(**counts), False
        if verb == "CORRUPT":
            # the bench/test divergence injector: flip one
            # byte of LIVE applied state.  Refused unless the operator
            # opted the daemon in — a production daemon cannot be asked
            # to corrupt itself over the wire
            if os.environ.get(ALLOW_CORRUPT_ENV, "") != "1":
                return err_line(
                    "unavailable",
                    f"CORRUPT is a rehearsal verb; set "
                    f"{ALLOW_CORRUPT_ENV}=1 to enable it"), False
            try:
                crc = core.corrupt_one_byte()
            except RuntimeError as exc:
                return err_line("unavailable", str(exc)), False
            return ok_kv(crc=crc, seqno=core.applied_seqno), False
        raise BadRequest(f"unhandled verb {verb!r}")  # unreachable

    def _handle_mig(self, req) -> str:
        """``MIG <op> <tenant> [k=v...]`` — the daemon-side migration
        surface (serve/migrate.py drives it from the router):
        ADOPT/CUT/DROP run on the target leader, SEAL/UNSEAL on the
        source leader, STAT anywhere.  Every op is idempotent — the
        driver retries through netfaults and kill -9 resumes."""
        from . import migrate
        if len(req.args) < 2:
            raise BadRequest("MIG wants <op> <tenant> [k=v...]")
        op = req.args[0].upper()
        name = req.args[1]
        kv = parse_kv_args(req.args[2:])
        if op not in ("ADOPT", "SEAL", "UNSEAL", "CUT", "DROP", "STAT"):
            raise BadRequest(f"unknown MIG op {op!r}")
        if op != "STAT" and self.role != "leader":
            self.counters["notleader"] += 1
            return err_line("notleader", self.leader_addr())
        try:
            if op == "ADOPT":
                try:
                    host = kv["host"]
                    port = int(kv["port"])
                except (KeyError, ValueError):
                    raise BadRequest(
                        "MIG ADOPT wants host=<h> port=<p>")
                return ok_kv(**migrate.target_adopt(self, name, host,
                                                    port))
            if op == "SEAL":
                dest = kv.get("dest")
                if not dest:
                    raise BadRequest("MIG SEAL wants dest=<cluster>")
                return ok_kv(**migrate.source_seal(self, name, dest))
            if op == "UNSEAL":
                return ok_kv(**migrate.source_unseal(self, name))
            if op == "CUT":
                try:
                    epoch = int(kv["epoch"])
                    expect = int(kv["expect"])
                except (KeyError, ValueError):
                    raise BadRequest(
                        "MIG CUT wants epoch=<int> expect=<seqno>")
                return ok_kv(**migrate.target_cut(self, name, epoch,
                                                  expect))
            if op == "DROP":
                return ok_kv(**migrate.target_drop(self, name))
            return ok_kv(**migrate.mig_stat(self, name))
        except UnknownTenant as exc:
            return err_line("notfound", exc.message)
        except migrate.MigrationError as exc:
            return err_line("unavailable", str(exc))

    def _handle_evict(self, req) -> str:
        """``EVICT <tenant>``: seal the tenant to a snapshot generation
        and drop it from memory (the deterministic face of the
        governor's pressure-driven eviction — tests and operators name
        the victim instead of waiting for the budget)."""
        if len(req.args) != 1:
            raise BadRequest("EVICT wants exactly one tenant name")
        name = req.args[0]
        try:
            t = self.tenants.get(name)
        except UnknownTenant as exc:
            return err_line("notfound", exc.message)
        if name == DEFAULT_TENANT:
            return err_line("badreq",
                            "the default tenant cannot be evicted")
        if not t.resident:
            return ok_kv(tenant=name, resident=0)  # already cold
        try:
            if not self.tenants.evict(name):
                return err_line(
                    "unavailable",
                    f"tenant {name} has replication streams attached; "
                    f"evicting it would strand them")
        except OSError as exc:
            return err_line("unavailable",
                            f"eviction seal failed ({exc}); tenant "
                            f"{name} stays resident")
        return ok_kv(tenant=name, resident=0)

    def _render_metrics(self) -> str:
        """The Prometheus scrape body: refresh the gauges from live
        state, then render the whole registry (obs/metrics.py)."""
        m = self.metrics
        core = self.core
        m.gauge("sheep_serve_applied_seqno",
                "highest WAL seqno applied").set(core.applied_seqno)
        m.gauge("sheep_serve_epoch",
                "replication epoch (term)").set(core.epoch)
        m.gauge("sheep_serve_inflight",
                "requests holding admission slots").set(
            self.admission.inflight)
        m.gauge("sheep_serve_uptime_seconds", "daemon uptime").set(
            round(time.monotonic() - self.started_at, 3))
        lag = m.gauge("sheep_serve_repl_lag_records",
                      "replication lag: max follower lag on a leader, "
                      "own lag on a follower")
        if self.role == "leader":
            lags = self.hub.lag_report()
            lag.set(max((f["lag"] for f in lags.values()), default=0))
            fol = m.gauge("sheep_serve_follower_lag_records",
                          "per-follower replication lag")
            for node, f in sorted(lags.items()):
                fol.labels(node=node).set(f["lag"])
        else:
            rep = self.replicator
            lag.set(rep.lag if rep is not None else 0)
        # per-tenant labels: residency, applied seqno, and
        # evict/restore counters per hosted tenant
        res = m.gauge("sheep_serve_tenant_resident",
                      "1 = tenant state is in memory, 0 = evicted to "
                      "its sealed snapshot")
        app = m.gauge("sheep_serve_tenant_applied_seqno",
                      "highest WAL seqno applied, per tenant")
        evg = m.gauge("sheep_serve_tenant_evictions_total",
                      "cold evictions per tenant")
        rsg = m.gauge("sheep_serve_tenant_restores_total",
                      "lazy restores per tenant")
        # migration visibility: phase as a labeled presence
        # gauge (snap/delta on a target adopting in, moved on a fenced
        # source) and the target's delta lag in records — `sheep top`
        # and the router's rebalancer read these off the fleet scrape
        mphase = m.gauge("sheep_serve_mig_phase",
                         "1 = tenant is in this migration phase here")
        mlag = m.gauge("sheep_serve_mig_delta_lag_records",
                       "migration delta-stream lag on the target")
        # sequence-drift visibility: the quality-decay gauges
        # an operator watches to see the re-sequence detector approach
        # its threshold, plus the generation the tenant serves
        sdrift = m.gauge("sheep_serve_seq_drift",
                         "inserts the current sequence mis-handles "
                         "(out-of-sequence or rank-moved) since the "
                         "last re-sequence cut")
        rsq = m.gauge("sheep_serve_reseqs_total",
                      "completed re-sequence swaps per tenant")
        sgen = m.gauge("sheep_serve_seq_gen",
                       "sequence generation currently served")
        # group-commit + seqlock visibility: the write-path
        # amortization (fsyncs vs records, recent group size quantiles)
        # and how often lock-free reads had to retry or take the lock —
        # `sheep top` derives fsyncs/s and grouping from these
        gcf = m.gauge("sheep_serve_group_commit_fsyncs_total",
                      "shared group-commit fsyncs on the leader write "
                      "path")
        gcr = m.gauge("sheep_serve_group_commit_records_total",
                      "insert records covered by group-commit fsyncs")
        gc50 = m.gauge("sheep_serve_group_commit_size_p50",
                       "p50 records per shared fsync (last 512 groups)")
        gc99 = m.gauge("sheep_serve_group_commit_size_p99",
                       "p99 records per shared fsync (last 512 groups)")
        slr = m.gauge("sheep_serve_read_seqlock_retries_total",
                      "lock-free read attempts discarded by a racing "
                      "write")
        slf = m.gauge("sheep_serve_read_seqlock_fallbacks_total",
                      "lock-free reads that fell back to the state lock")
        # anti-entropy visibility: per-tenant quarantine
        # state plus daemon-lifetime scrub totals — `sheep top`'s
        # DIVERGED/SCRUB columns and the router's health view read these
        dvg = m.gauge("sheep_diverged",
                      "1 = tenant state diverged from the leader "
                      "(quarantined; reads refused until re-sync)")
        m.gauge("sheep_scrub_runs_total",
                "completed anti-entropy scrub passes").set(
            self.scrub_totals["runs"])
        m.gauge("sheep_scrub_checked_total",
                "sealed artifacts re-verified by the scrubber").set(
            self.scrub_totals["checked"])
        m.gauge("sheep_scrub_quarantined_total",
                "artifacts renamed *.quarantined by the scrubber").set(
            self.scrub_totals["quarantined"])
        m.gauge("sheep_scrub_repaired_total",
                "quarantined artifacts repaired back under their real "
                "name").set(self.scrub_totals["repaired"])
        m.gauge("sheep_scrub_unrepaired_total",
                "quarantined artifacts with no surviving repair input"
                ).set(self.scrub_totals["unrepaired"])
        for name in self.tenants.names():
            t = self.tenants.get(name)
            res.labels(tenant=name).set(int(t.resident))
            if t.core is not None:
                app.labels(tenant=name).set(t.core.applied_seqno)
                sdrift.labels(tenant=name).set(t.core.seq_drift)
                rsq.labels(tenant=name).set(t.core.reseqs)
                sgen.labels(tenant=name).set(t.core.seq_gen)
                gcf.labels(tenant=name).set(t.core.gc_fsyncs)
                gcr.labels(tenant=name).set(t.core.gc_records)
                gc50.labels(tenant=name).set(
                    t.core._gc_size_quantile(0.5))
                gc99.labels(tenant=name).set(
                    t.core._gc_size_quantile(0.99))
                slr.labels(tenant=name).set(t.core.seqlock_retries)
                slf.labels(tenant=name).set(t.core.seqlock_fallbacks)
                dvg.labels(tenant=name).set(
                    int(getattr(t.core, "quarantined", False)))
            evg.labels(tenant=name).set(t.evictions)
            rsg.labels(tenant=name).set(t.restores)
            if t.mig is not None:
                mphase.labels(tenant=name,
                              phase=t.mig.get("phase", "?")).set(1)
                rep = t.mig.get("replicator")
                mlag.labels(tenant=name).set(
                    rep.lag if rep is not None else 0)
            elif t.moved_dest is not None:
                mphase.labels(tenant=name, phase="moved").set(1)
        # sliding-window latency gauges: what `sheep top`
        # renders as CURRENT p50/p99 — the lifetime histogram series
        # above are untouched for scrapers that integrate them
        w50 = m.gauge("sheep_serve_window_p50_seconds",
                      "sliding-window (~30s) p50 request latency by verb")
        w99 = m.gauge("sheep_serve_window_p99_seconds",
                      "sliding-window (~30s) p99 request latency by verb")
        for key, child in sorted(self._m_latency.children().items()):
            if not child.window_count():
                continue
            verb = dict(key).get("verb", "?")
            w50.labels(verb=verb).set(
                round(child.window_quantile(0.5), 6))
            w99.labels(verb=verb).set(
                round(child.window_quantile(0.99), 6))
        tw99 = m.gauge("sheep_serve_tenant_window_p99_seconds",
                       "sliding-window (~30s) p99 request latency by "
                       "tenant")
        for key, child in sorted(self._m_tenant_latency
                                 .children().items()):
            if not child.window_count():
                continue
            tw99.labels(tenant=dict(key).get("tenant", "?")).set(
                round(child.window_quantile(0.99), 6))
        # standard process self-accounting, refreshed on scrape (the
        # accounting a bench would capture from outside rides every
        # METRICS payload)
        from ..obs.metrics import set_process_gauges
        set_process_gauges(m, self.started_at)
        return m.render()

    def _metrics_response(self) -> str:
        """``METRICS`` -> ``OK bytes=<n>`` followed by the n-byte scrape
        body (the snapshot-transfer shape: the one-line protocol stays
        one HEADER line, the payload is length-prefixed raw bytes).  The
        count includes the body's final newline, which the connection
        writer appends to every response."""
        body = self._render_metrics()  # always newline-terminated
        return f"OK bytes={len(body)}\n" + body[:-1]

    def _stats_line(self, tenant: Tenant | None = None) -> str:
        if tenant is None:
            tenant = self.tenants.get(DEFAULT_TENANT)
        core = self.tenants.core_of(tenant.name)
        rec = core.stats()
        rec.update(self.counters)
        adm = tenant.admission or self.admission
        rec["inflight"] = adm.inflight
        rec["uptime_s"] = round(time.monotonic() - self.started_at, 3)
        rec["read_only"] = int(adm.read_only
                               or core.governor.mem_pressure())
        rec["role"] = self.role
        rec["node"] = self.node_id
        rec["leader"] = self.leader_addr()
        # anti-entropy health: the router's read spread and
        # the election candidate filter both key on `diverged`
        rec["diverged"] = int(getattr(core, "quarantined", False))
        rec["scrub_runs"] = self.scrub_totals["runs"]
        rec["scrub_quarantined"] = self.scrub_totals["quarantined"]
        rec["scrub_repaired"] = self.scrub_totals["repaired"]
        rep = tenant.replicator
        if rep is not None and rep.quarantine_heals:
            rec["quarantine_heals"] = rep.quarantine_heals
        if self.role == "leader":
            hub = tenant.hub if tenant.hub is not None else self.hub
            lags = hub.lag_report()
            rec["followers"] = len(lags)
            rec["repl_lag"] = max((f["lag"] for f in lags.values()),
                                  default=0)
            for node, f in sorted(lags.items()):
                rec[f"lag_{node}"] = f["lag"]
        else:
            rep = tenant.replicator
            rec["followers"] = 0
            rec["repl_lag"] = rep.lag if rep is not None else 0
            rec["leader_seqno"] = (rep.leader_seqno if rep is not None
                                   else core.applied_seqno)
        if len(self.tenants) > 1:
            rec["tenant"] = tenant.name
            rec["tenants"] = len(self.tenants)
            rec["tenants_resident"] = len(self.tenants.resident_names())
        if tenant.moved_dest is not None:
            rec["moved_dest"] = tenant.moved_dest
        if tenant.mig is not None:
            rec["mig_phase"] = tenant.mig.get("phase", "?")
            rep = tenant.mig.get("replicator")
            rec["mig_lag"] = rep.lag if rep is not None else 0
        # daemon-wide migration summary: visible from ANY
        # connection (supervise --status asks without a tenant select),
        # not just one mid-migration tenant's
        moving = []
        for name in self.tenants.names():
            t = self.tenants.get(name)
            if t.mig is not None:
                moving.append(f"{name}:{t.mig.get('phase', '?')}")
            elif t.moved_dest is not None:
                moving.append(f"{name}:moved->{t.moved_dest}")
        if moving:
            rec["migrating"] = ",".join(sorted(moving))
        # per-verb counts + latency quantiles, derived from the SAME
        # histogram registry the METRICS scrape exports —
        # the wire summary and the scrape cannot disagree
        for key, child in sorted(self._m_requests.children().items()):
            verb = dict(key).get("verb", "?").lower()
            rec[f"req_{verb}"] = int(child.value)
        for key, child in sorted(self._m_latency.children().items()):
            if not child.count:
                continue
            verb = dict(key).get("verb", "?").lower()
            rec[f"p50_{verb}_ms"] = round(child.quantile(0.5) * 1000, 3)
            rec[f"p99_{verb}_ms"] = round(child.quantile(0.99) * 1000, 3)
            # the sliding-window view: current latency for
            # `sheep top`; the lifetime p50_/p99_ keys above are
            # unchanged for existing scrapers
            if child.window_count():
                rec[f"w50_{verb}_ms"] = round(
                    child.window_quantile(0.5) * 1000, 3)
                rec[f"w99_{verb}_ms"] = round(
                    child.window_quantile(0.99) * 1000, 3)
        return ok_kv(**rec)

    # -- status file (the dead-daemon face of STATS) -----------------------

    def status_dict(self) -> dict:
        """Machine-readable role/epoch/lag snapshot — what STATS says on
        the wire, persisted for monitors that outlive the process
        (supervisor/status.py renders it when the daemon is down)."""
        core = self.core
        out = {
            "t": time.time(),
            "role": self.role,
            "node": self.node_id,
            "epoch": core.epoch,
            "applied_seqno": core.applied_seqno,
            "leader": self.leader_addr(),
            "peers": list(self.cluster.peers),
            "diverged": int(getattr(core, "quarantined", False)),
            "scrub_runs": self.scrub_totals["runs"],
            "scrub_repaired": self.scrub_totals["repaired"],
        }
        if self.role == "leader":
            out["followers"] = self.hub.lag_report()
        else:
            rep = self.replicator
            out["repl_lag"] = rep.lag if rep is not None else 0
            out["stream_age_s"] = (rep.stream_age_s()
                                   if rep is not None else None)
        if len(self.tenants) > 1:
            out["tenants"] = {}
            for name in self.tenants.names():
                t = self.tenants.get(name)
                rec = {"resident": int(t.resident),
                       "evictions": t.evictions,
                       "restores": t.restores}
                if t.moved_dest is not None:
                    rec["moved_dest"] = t.moved_dest
                if t.mig is not None:
                    rec["mig_phase"] = t.mig.get("phase", "?")
                    rep = t.mig.get("replicator")
                    rec["mig_lag"] = rep.lag if rep is not None else 0
                out["tenants"][name] = rec
        return out

    def _write_status(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._status_written < 1.0:
            return
        self._status_written = now
        path = os.path.join(self.core.state_dir, STATUS_FILE)
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.status_dict(), f)
            os.replace(tmp, path)
        except OSError:
            pass  # status is advisory; never let it hurt serving

    def _maybe_background_repartition(self, core: ServeCore) -> None:
        """Kick the drift-triggered repartition exactly once at a time;
        queries serve the stale partition until the swap (state.py).
        One at a time is daemon-wide, not per tenant — the partitioner
        is the expensive thing being rationed, tenants just take
        turns."""
        if not core.drift_exceeded():
            return
        if not self._repartitioning.acquire(blocking=False):
            return  # one already running

        def work():
            try:
                core.repartition()
                self.config.events.append(("repartition",
                                           core.repartitions))
            finally:
                self._repartitioning.release()

        t = threading.Thread(target=work, daemon=True,
                             name="serve-repartition")
        t.start()

    def _maybe_background_reseq(self, core: ServeCore, hub) -> None:
        """Kick the sequence-drift-triggered re-sequence
        exactly once at a time, daemon-wide — the streamed fold is the
        expensive thing being rationed.  Queries serve the stale (but
        consistent) generation until the ticket-guarded swap; the run
        itself is priced by plan_reseq and may still decline."""
        if not self.config.reseq or self.role != "leader":
            return
        if not core.seq_drift_exceeded():
            return
        if not self._resequencing.acquire(blocking=False):
            return  # one already running

        def work():
            try:
                from .reseq import run_reseq
                res = run_reseq(core, hub=hub,
                                events=self.config.events)
                self.config.events.append(
                    ("reseq", core.reseqs, res.get("reason", "")))
            except Exception as exc:
                # the old generation keeps serving; the detector will
                # re-fire and retry off the durable manifest
                self.config.events.append(("reseq_error", str(exc)))
            finally:
                self._resequencing.release()

        t = threading.Thread(target=work, daemon=True,
                             name="serve-reseq")
        t.start()

    def _resume_pending_reseqs(self) -> None:
        """Startup sweep (leader only): any tenant whose state dir holds
        an in-flight reseq manifest — a kill -9 mid-rebuild — resumes
        (or cleanly aborts) it in the background, off the manifest's
        durable phase."""
        if not self.config.reseq or self.role != "leader":
            return
        from .reseq import active, resume_reseq
        pending = []
        for name in self.tenants.names():
            t = self.tenants.get(name)
            if t.core is not None and t.core.state_dir \
                    and active(t.core.state_dir):
                pending.append(t)
        if not pending:
            return
        if not self._resequencing.acquire(blocking=False):
            return

        def work():
            try:
                for t in pending:
                    try:
                        res = resume_reseq(t.core, hub=self._hub_for(t),
                                           events=self.config.events)
                        if res is not None:
                            self.config.events.append(
                                ("reseq_resume", t.name, res))
                    except Exception as exc:
                        self.config.events.append(
                            ("reseq_error", f"{t.name}: {exc}"))
            finally:
                self._resequencing.release()

        threading.Thread(target=work, daemon=True,
                         name="serve-reseq-resume").start()

    # -- anti-entropy -------------------------------------------

    def _sweep_quarantine(self) -> None:
        """Startup sweep: a durable quarantine marker in any tenant's
        state dir means a kill -9 interrupted a divergence heal — the
        restarted daemon re-enters the quarantine (reads refused) and
        lets that tenant's follower stream resume the heal off the
        marker's phase."""
        from . import scrub as scrub_mod
        for name in self.tenants.names():
            t = self.tenants.get(name)
            if t.core is None or not t.core.state_dir:
                continue
            marker = scrub_mod.read_quarantine(t.core.state_dir)
            if marker is not None:
                t.core.quarantined = True
                self.config.events.append(
                    ("quarantine_resumed", name,
                     marker.get("phase", "?")))

    def _scrub_source(self, tenant: Tenant) -> tuple[str, int] | None:
        """Where a scrub may fetch a clean snapshot from: a follower's
        connected leader; a leader repairs from its own live core."""
        rep = tenant.replicator
        if rep is not None and rep.connected_to is not None:
            return rep.connected_to
        return None

    def _scrub_tenant(self, tenant: Tenant, core: ServeCore) -> dict:
        """One scrub pass over one tenant (caller holds _scrubbing).
        A quarantined core's state is suspect, so it never reseals its
        own snapshots — repairs come from the leader instead."""
        from . import scrub as scrub_mod
        counts = scrub_mod.run_scrub(
            core.state_dir,
            core=None if getattr(core, "quarantined", False) else core,
            leader=self._scrub_source(tenant), tenant=tenant.name)
        self.scrub_totals["runs"] += 1
        for k in ("checked", "failed", "quarantined", "repaired",
                  "unrepaired"):
            self.scrub_totals[k] += counts.get(k, 0)
        if counts.get("failed"):
            self.config.events.append(
                ("scrub", tenant.name, counts["failed"],
                 counts["repaired"]))
        return counts

    def _maybe_background_scrub(self) -> None:
        """Kick the paced background scrub when its interval elapses —
        one at a time daemon-wide, priced by plan_scrub so a pass that
        cannot amortize inside its horizon declines (the same GO/STAY
        discipline as the reseq job)."""
        interval = self.config.scrub_interval_s
        if interval <= 0:
            return
        now = time.monotonic()
        if now - self._last_scrub < interval:
            return
        if not self._scrubbing.acquire(blocking=False):
            return
        self._last_scrub = now

        def work():
            from . import scrub as scrub_mod
            from ..plan.model import plan_scrub
            try:
                for name in self.tenants.names():
                    t = self.tenants.get(name)
                    core = t.core
                    if core is None or not core.state_dir:
                        continue
                    paths = scrub_mod.sealed_artifacts(core.state_dir)
                    total = 0
                    for p in paths:
                        try:
                            total += os.path.getsize(p)
                        except OSError:
                            pass
                    plan = plan_scrub(len(paths), total)
                    if plan["decision"] != "go":
                        self.config.events.append(
                            ("scrub_declined", name, plan["reason"]))
                        continue
                    self._scrub_tenant(t, core)
            except Exception as exc:
                # scrubbing is maintenance; it never hurts serving
                self.config.events.append(("scrub_error", str(exc)))
            finally:
                self._scrubbing.release()

        threading.Thread(target=work, daemon=True,
                         name="serve-scrub").start()
