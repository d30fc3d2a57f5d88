"""serve: run the crash-safe, replicated partition service (port of
sheep_tpu/cli/serve.py).

The daemon keeps the tree + partition resident and serves
part/ECV/subtree queries plus WAL-backed incremental inserts over the
line protocol (sheep_tpu_torch.serve.protocol).  It is host code: the
process never loads torch.

    python -m sheep_tpu_torch.cli.serve -d state/ -g graph.dat -k 8
    python -m sheep_tpu_torch.cli.serve -d state/ -T g.tre -s g.seq -g g.dat
    python -m sheep_tpu_torch.cli.serve -d state/      # restart: snapshot+WAL
    python -m sheep_tpu_torch.cli.serve -d lead/ -g g.dat --role leader \
        --peers f1/,f2/
    python -m sheep_tpu_torch.cli.serve -d f1/ --role follower \
        --peers lead/,f2/                               # joins + streams
    python -m sheep_tpu_torch.cli.serve -d state/ -g g.dat \
        --tenant web=web/:web.dat:8 --tenant social=soc/   # multi-tenant

First start (artifact flags given) bootstraps the state dir: artifacts
load through the strict integrity readers, generation-0 snapshot seals
sidecar-first, an empty WAL is created.  Restart (no artifact flags)
recovers: newest loadable snapshot + WAL replay — bit-identical to the
pre-crash tree; a torn trailing WAL record is refused in strict mode and
truncated under ``-m repair``.  A FOLLOWER with an empty state dir and
no artifacts bootstraps over the wire instead: it fetches the leader's
sealed snapshot (crc-verified, resealed locally) and then tails the WAL
stream (serve/replicate.py).

Options:
  -d DIR     state dir (required): snapshots + WAL + serve.addr/serve.hb
  -g GRAPH   edge file; with no -T/-s the sequence+tree are built from it
  -T TRE     tree artifact (pairs with -s)
  -s SEQ     sequence artifact
  -P FILE    jnid-indexed partition file (default: partition in-process)
  -k N       number of partitions (default 2; ignored with -P)
  -p PORT    listen port (default 0 = ephemeral; the bound address is
             printed and written to <state-dir>/serve.addr)
  -H HOST    bind host (default 127.0.0.1)
  -m MODE    integrity policy for recovery: strict (default) / repair
  -b F       partition balance factor (default 1.03)
  --role R   leader | follower (default SHEEP_SERVE_ROLE or leader)
  --peers L  comma list of peers: host:port, a peer's state dir, or an
             addr file (default SHEEP_SERVE_PEERS)
  --node-id N  this node's id for election tie-breaks and lag reports
             (default SHEEP_SERVE_NODE_ID or host:port)
  --tenant name=dir[:graph[:k]]   host another serve state dir behind
             this daemon (repeatable; also SHEEP_SERVE_TENANTS as a
             comma list of the same entries).  Connections select it
             with the ``TENANT name`` verb; an empty dir bootstraps
             from its :graph (or, on a clustered follower, over the
             wire from the leader's same-named tenant).  Cold tenants
             evict to their sealed snapshot under memory pressure
             (SHEEP_MEM_BUDGET / SHEEP_SERVE_MAX_RESIDENT) and restore
             lazily on the next touch.

Env: SHEEP_SERVE_DEADLINE_S, SHEEP_SERVE_MAX_INFLIGHT,
SHEEP_SERVE_SNAP_EVERY, SHEEP_SERVE_DRIFT, SHEEP_SERVE_DRIFT_MIN,
SHEEP_SERVE_GROUP_COMMIT_MAX / _DELAY_S (leader group-commit window),
SHEEP_SERVE_TENANTS (comma list of name=dir[:graph[:k]]),
SHEEP_SERVE_MAX_RESIDENT (resident-tenant cap; cold ones evict),
SHEEP_TRACE_SAMPLE (1/N per-request serve.req span sampling),
SHEEP_SERVE_ROLE, SHEEP_SERVE_PEERS, SHEEP_SERVE_NODE_ID,
SHEEP_SERVE_REPL_ACKS (follower acks per insert OK, default 1),
SHEEP_SERVE_REPL_HB_S, SHEEP_SERVE_FAILOVER_S, SHEEP_SERVE_MAX_LAG
(bounded staleness for follower reads), SHEEP_SERVE_FAULT_PLAN
(serve/faults.py), SHEEP_SERVE_NETFAULT_PLAN (serve/netfaults.py),
SHEEP_IO_FAULT_PLAN sites ``wal``/``snap``, SHEEP_MEM_BUDGET (read-only
degradation).

Exit codes: 0 clean shutdown, 1 startup/recovery failure, 2 usage error.
"""

from __future__ import annotations

import getopt
import os
import signal
import sys

from ..integrity.errors import IntegrityError
from ..integrity.sidecar import POLICIES

USAGE = ("USAGE: serve -d state_dir [-g graph] [-T tree -s seq] [-P parts]"
         " [-k num_parts] [-p port] [-H host] [-m strict|repair]"
         " [-b balance] [--role leader|follower] [--peers p1,p2]"
         " [--node-id id] [--tenant name=dir[:graph[:k]] ...]")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "d:g:T:s:P:k:p:H:m:b:",
                                       ["role=", "peers=", "node-id=",
                                        "tenant="])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2

    state_dir = None
    graph = tre = seq = parts_file = None
    num_parts = 2
    port = 0
    host = "127.0.0.1"
    mode = None
    balance = 1.03
    cluster_kw: dict = {}
    tenant_args: list[str] = []
    for o, a in opts:
        if o == "-d":
            state_dir = a
        elif o == "-g":
            graph = a
        elif o == "-T":
            tre = a
        elif o == "-s":
            seq = a
        elif o == "-P":
            parts_file = a
        elif o == "-k":
            num_parts = int(a)
        elif o == "-p":
            port = int(a)
        elif o == "-H":
            host = a
        elif o == "-m":
            if a not in POLICIES:
                print(f"serve: -m {a!r} must be one of "
                      f"{'/'.join(POLICIES)}")
                return 2
            mode = a
        elif o == "-b":
            balance = float(a)
        elif o == "--role":
            cluster_kw["role"] = a.strip().lower()
        elif o == "--peers":
            cluster_kw["peers"] = [p.strip() for p in a.split(",")
                                   if p.strip()]
        elif o == "--node-id":
            cluster_kw["node_id"] = a.strip()
        elif o == "--tenant":
            tenant_args.append(a.strip())

    if state_dir is None or args:
        print(USAGE)
        return 2

    from ..serve import (ClusterConfig, ServeConfig, ServeCore,
                         ServeDaemon, TenantManager, parse_tenant_specs)
    from ..serve.state import snap_paths

    config = ServeConfig.from_env(host=host, port=port)
    try:
        cluster = ClusterConfig.from_env(**cluster_kw)
        tenant_specs = parse_tenant_specs(",".join(tenant_args))
    except ValueError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 2
    core_kw = dict(snap_every=config.snap_every,
                   drift_frac=config.drift_frac,
                   drift_min_cut=config.drift_min_cut,
                   reseq_frac=config.reseq_frac,
                   reseq_min=config.reseq_min,
                   reseq_rank=config.reseq_rank,
                   group_commit_max=config.group_commit_max,
                   group_commit_delay_s=config.group_commit_delay_s)
    try:
        bootstrap = not snap_paths(state_dir) if os.path.isdir(state_dir) \
            else True
        if bootstrap and graph is None and tre is None \
                and cluster.clustered and cluster.role == "follower":
            # over-the-wire bootstrap: fetch the leader's snapshot, then
            # enter through the exact restart path
            from ..serve.cluster import find_leader
            from ..serve.replicate import bootstrap_state_dir
            found = None
            deadline = 60.0
            import time as _time
            t0 = _time.monotonic()
            while found is None and _time.monotonic() - t0 < deadline:
                found = find_leader(cluster.peers,
                                    cluster.poll_timeout_s)
                if found is None:
                    _time.sleep(0.2)
            if found is None:
                print(f"serve: follower bootstrap found no reachable "
                      f"leader among {cluster.peers}", file=sys.stderr)
                return 1
            lhost, _, lport = found[0].rpartition(":")
            bootstrap_state_dir(state_dir, lhost, int(lport))
            bootstrap = False
        if bootstrap:
            if graph is None and tre is None:
                print(f"serve: {state_dir} holds no snapshots and no "
                      f"artifacts were given to bootstrap from", flush=True,
                      file=sys.stderr)
                return 1
            core = ServeCore.bootstrap(
                state_dir, tre_path=tre, seq_path=seq, graph_path=graph,
                parts_path=parts_file, num_parts=num_parts,
                balance=balance, integrity=mode, **core_kw)
        else:
            core = ServeCore.open(state_dir, integrity=mode, **core_kw)
    except (IntegrityError, OSError, ValueError) as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 1

    try:
        tenants = TenantManager.from_env(core, extra_specs=tenant_specs,
                                         open_kw=core_kw)
    except ValueError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 2
    if cluster.clustered and cluster.role == "follower":
        # named tenants with empty dirs bootstrap over the wire from the
        # leader's same-named tenant, exactly like the default did above
        from ..serve.cluster import find_leader
        from ..serve.replicate import bootstrap_state_dir
        for name in tenants.names():
            t = tenants.get(name)
            if t.core is not None or (os.path.isdir(t.state_dir)
                                      and snap_paths(t.state_dir)):
                continue
            found = find_leader(cluster.peers, cluster.poll_timeout_s)
            if found is None:
                print(f"serve: tenant {name!r} bootstrap found no "
                      f"reachable leader", file=sys.stderr)
                return 1
            lhost, _, lport = found[0].rpartition(":")
            bootstrap_state_dir(t.state_dir, lhost, int(lport),
                                tenant=name)

    daemon = ServeDaemon(core, config, cluster=cluster,
                         tenants=tenants).start()
    h, p = daemon.address
    st = core.stats()
    print(f"serve: listening on {h}:{p}", flush=True)
    print(f"serve: ready role={daemon.role} epoch={st['epoch']} "
          f"n={st['n']} links={st['links']} "
          f"applied={st['applied_seqno']} inserted={st['inserted']}",
          flush=True)

    def _term(signum, frame):
        daemon.shutdown()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        daemon.run_forever()
    finally:
        daemon.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
