"""route: the consistent-hash router over serve clusters (port of
sheep_tpu/cli/route.py).

This daemon fronts N replicated serve clusters (serve/router.py) and
speaks the same line grammar, so any serve client points at the router
instead of a daemon and gains tenant placement, read spreading, and
epoch-safe failover retries for free.  It is host code: the process
never loads torch.

    python -m sheep_tpu_torch.cli.route --cluster lead/,f1/ -p 7700
    python -m sheep_tpu_torch.cli.route --cluster a@la/,fa/ \
        --cluster b@lb/,fb/                              # named shards
    SHEEP_ROUTE_CLUSTERS="la/,fa/;lb/,fb/" \
        python -m sheep_tpu_torch.cli.route -d rdir/

Options:
  --cluster SPEC   one cluster as [name@]peer,peer (repeatable; peers
                   are host:port, a serve state dir, or an addr file —
                   serve/cluster.py grammar).  Default: the env.
  -d DIR           state dir: router.addr is published there (like
                   serve.addr) for scripts that need the bound port
  -p PORT          listen port (default 0 = ephemeral, printed)
  -H HOST          bind host (default 127.0.0.1)
  --vnodes N       ring points per cluster (default 64; also
                   SHEEP_ROUTE_VNODES)

Env: SHEEP_ROUTE_CLUSTERS (";"-separated clusters of ","-separated
peers), SHEEP_ROUTE_VNODES.  SHEEP_REBALANCE=1 additionally starts the
self-rebalancer (serve/rebalance.py): the router watches its own fleet
scrape and live-migrates the busiest tenant off a sustained-hot
cluster — hysteresis, min-qps, one-migration-at-a-time, and a cooldown
keep it from flapping (SHEEP_REBALANCE_* knobs).

Exit codes: 0 clean shutdown, 1 startup failure, 2 usage error.
"""

from __future__ import annotations

import getopt
import os
import signal
import sys

USAGE = ("USAGE: route [--cluster [name@]peer,peer ...] [-d dir]"
         " [-p port] [-H host] [--vnodes n]")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "d:p:H:",
                                       ["cluster=", "vnodes="])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2

    from ..serve.router import CLUSTERS_ENV, VNODES_ENV, Router, \
        parse_clusters

    state_dir = None
    port = 0
    host = "127.0.0.1"
    cluster_args: list[str] = []
    vnodes = int(os.environ.get(VNODES_ENV, "64") or "64")
    for o, a in opts:
        if o == "-d":
            state_dir = a
        elif o == "-p":
            port = int(a)
        elif o == "-H":
            host = a
        elif o == "--cluster":
            cluster_args.append(a.strip())
        elif o == "--vnodes":
            vnodes = int(a)
    if args:
        print(USAGE)
        return 2

    spec = ";".join(cluster_args) if cluster_args \
        else os.environ.get(CLUSTERS_ENV, "")
    try:
        clusters = parse_clusters(spec)
    except ValueError as exc:
        print(f"route: {exc}", file=sys.stderr)
        return 2

    try:
        router = Router(clusters, host=host, port=port,
                        state_dir=state_dir, vnodes=vnodes).start()
    except OSError as exc:
        print(f"route: {exc}", file=sys.stderr)
        return 1
    h, p = router.address
    print(f"route: listening on {h}:{p}", flush=True)
    print(f"route: ready clusters={len(clusters)} "
          f"({', '.join(sorted(clusters))})", flush=True)

    from ..serve import rebalance
    if rebalance.enabled():
        router.rebalancer = rebalance.Rebalancer(router).start()
        print(f"route: rebalancer on (interval "
              f"{router.rebalancer.interval_s:g}s, hysteresis "
              f"{router.rebalancer.hysteresis:g}x, cooldown "
              f"{router.rebalancer.cooldown_s:g}s)", flush=True)

    def _term(signum, frame):
        if router.rebalancer is not None:
            router.rebalancer.stop()
        router.shutdown()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        router.run_forever()
    finally:
        router.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
