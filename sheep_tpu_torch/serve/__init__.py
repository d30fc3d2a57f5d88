"""The serve tier (port of sheep_tpu/serve): the crash-safe, replicated
partition service and the routed fleet in front of it.  The tree and
partition stay resident in a state dir; incremental edge inserts fold in
by the batch build's union-find transform through a group-committed write-ahead log,
so nothing acknowledged is lost.  A leader ships that WAL to followers,
which apply it through the same insert path and serve reads; failover
is an epoch-fenced, quorum-voted promotion.  A router hashes tenants
onto clusters, and a tenant moves between clusters by live migration,
which the router's rebalancer starts on its own.  All of it is host
code: it loads no torch.

  wal.py        checksummed, fsync'd, epoch-stamped write-ahead log
  state.py      ServeCore: snapshot format, recovery (snapshot+replay),
                the incremental insert transform, queries, drift-
                triggered repartition, group commit, seqlock'd reads,
                replicated apply + epoch fences
  reseq.py      the crash-safe re-sequence job (``run_reseq``,
                ``resume_reseq``) and its manifest chain
  admission.py  slot + memory-pressure shedding (inserts shed first,
                read-only under pressure)
  protocol.py   the wire grammar + reference client (REPL verbs)
  daemon.py     selectors I/O loop, deadlines, fault hooks, heartbeat
                liveness, cluster roles
  replicate.py  WAL shipping: frame codec, leader hub, follower applier
  cluster.py    membership, leader discovery, quorum-vote elections,
                epoch-fenced failover
  scrub.py      anti-entropy: quarantine markers, the hash-chained
                scrub.json, artifact repairs
  tenants.py    multi-tenancy: N state dirs behind one daemon, the
                TENANT selector, governor-priced eviction
  worker.py     remote build workers: distext legs over the wire
  router.py     the fleet tier: consistent-hash tenants onto clusters,
                read spreading, epoch-safe retries, placement
                overrides, the fleet scrape
  migrate.py    live tenant migration: snapshot bootstrap, delta
                stream, epoch-fenced cutover, resumable manifests
  rebalance.py  the router's rebalancer: fleet scrape -> priced verdict
  faults.py     SHEEP_SERVE_FAULT_PLAN (kill/hang/slow @ request sites)
  netfaults.py  SHEEP_SERVE_NETFAULT_PLAN (drop/partition/slow/dup @
                replication frame sites)

Operational face: ``python -m sheep_tpu_torch.cli.serve`` and
``python -m sheep_tpu_torch.cli.route`` (``cli.top`` watches it); state
dirs are fsck-able (``python -m sheep_tpu_torch.cli.fsck state-dir/``
checks ``.wal``, ``.snap``, ``reseq.json``, ``scrub.json`` and the
quarantine markers).
"""

from .admission import AdmissionController, Overloaded, ReadOnly
from .cluster import (ClusterConfig, choose_successor, find_leader,
                      request_vote)
from .tenants import (DEFAULT_TENANT, TenantManager, TenantSpec,
                      UnknownTenant, parse_tenant_specs)
from .daemon import ServeConfig, ServeDaemon
from .faults import (SERVE_FAULT_PLAN_ENV, ServeKilled,
                     parse_serve_fault_plan)
from .netfaults import NETFAULT_PLAN_ENV, parse_netfault_plan
from .protocol import ServeClient, ServeError, connect_retry
from .replicate import (ReplApplier, ReplicationHub, Replicator,
                        bootstrap_state_dir, encode_append, parse_frame)
from .reseq import resume_reseq, run_reseq
from .router import HashRing, Router, parse_clusters
from .state import ReplicationGap, ServeCore, ecv_down, insert_link
from .wal import WalAppender, create_wal, read_wal, repair_wal

__all__ = [
    "AdmissionController",
    "ClusterConfig",
    "DEFAULT_TENANT",
    "HashRing",
    "NETFAULT_PLAN_ENV",
    "Overloaded",
    "ReadOnly",
    "ReplApplier",
    "ReplicationGap",
    "ReplicationHub",
    "Replicator",
    "Router",
    "SERVE_FAULT_PLAN_ENV",
    "ServeClient",
    "ServeConfig",
    "ServeCore",
    "ServeDaemon",
    "ServeError",
    "ServeKilled",
    "TenantManager",
    "TenantSpec",
    "UnknownTenant",
    "WalAppender",
    "bootstrap_state_dir",
    "choose_successor",
    "connect_retry",
    "create_wal",
    "ecv_down",
    "encode_append",
    "find_leader",
    "insert_link",
    "parse_clusters",
    "parse_frame",
    "parse_netfault_plan",
    "parse_serve_fault_plan",
    "parse_tenant_specs",
    "read_wal",
    "repair_wal",
    "request_vote",
    "resume_reseq",
    "run_reseq",
]
