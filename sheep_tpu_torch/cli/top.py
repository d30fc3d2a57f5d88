"""top: the fleet's live operator console (port of
sheep_tpu/cli/top.py).

This is the read side of the router's fleet scrape (serve/router.py
``fleet_metrics``): one ``METRICS`` request to the router fans in every
reachable cluster member, and this tool renders the result as a
refreshing per-tenant table.  It is host code: the process never loads
torch::

    python -m sheep_tpu_torch.cli.top -d route-dir/     # router.addr
    python -m sheep_tpu_torch.cli.top -r 127.0.0.1:7700 # router or daemon
    python -m sheep_tpu_torch.cli.top --json -i 0.5     # one snapshot

Columns (per tenant): the hosting cluster, current qps (counter delta
between two scrapes), windowed p99 (the sliding-window gauge — CURRENT
latency, not since-boot), max replication lag and epoch across the
instances hosting the tenant, and how many instances hold it resident.
While a live migration is visible two extra columns appear:
``MIG`` (snap/delta/cutover on the adopting target, ``moved`` on the
fenced source) and ``DLAG`` (delta-stream records the target still
trails by); the footer adds the router's migration tallies and, when
the rebalancer is on, its go/hold verdict counts.  Likewise once a
tenant reports sequence drift or a completed re-sequence
the ``SDRIFT`` (out-of-sequence inserts since the last cut) and
``RESEQ`` (completed re-sequence generations) columns appear.  Once a
tenant has paid a group-commit fsync or a lock-free read has retried
the write-path columns appear: ``FSYN/s`` (shared WAL
fsyncs per second — the amortization the group commit buys), ``GC50``
/ ``GC99`` (records per shared fsync, p50/p99) and ``SLRT`` (seqlock
read retries).  Anti-entropy: a ``DVRG`` column appears
once any tenant is quarantined (state diverged from the leader; reads
refused until re-sync), and the instance footer grows
``SCRUB``/``QUAR``/``REP`` (scrub passes, artifacts quarantined,
artifacts repaired) once any member has completed a scrub pass.  An
``instances`` footer shows per-instance epoch/lag/RSS from the same
scrape.

``--json`` takes two scrapes ``-i`` seconds apart (default 1.0; 0 =
single scrape, qps null) and prints one JSON object — what the tier-1
smoke and scripts consume.  Interactive mode refreshes every ``-i``
seconds (default 2) until ``-n`` iterations or Ctrl-C.

Exit codes: 0 rendered, 1 unreachable/unparseable, 2 usage error.
"""

from __future__ import annotations

import getopt
import json
import os
import sys
import time

from ..obs.metrics import parse_prometheus
from ..serve.protocol import ServeClient

USAGE = ("USAGE: top [-r host:port | -d state-dir] [-i interval_s] "
         "[-n iterations] [--json]")


def resolve_addr(host_port: str | None,
                 state_dir: str | None) -> tuple[str, int] | None:
    if host_port:
        host, _, port = host_port.rpartition(":")
        try:
            return (host or "127.0.0.1"), int(port)
        except ValueError:
            return None
    if state_dir:
        for name in ("router.addr", "serve.addr", "worker.addr"):
            try:
                host, port = open(os.path.join(state_dir, name)) \
                    .read().split()
                return host, int(port)
            except (OSError, ValueError):
                continue
    return None


def fleet_view(samples) -> dict:
    """Shape one scrape's samples into the per-tenant / per-instance
    view the table renders.  Tenant residency series name the hosting
    instances; lag/epoch roll up as max over those instances."""
    tenants: dict[str, dict] = {}
    instances: dict[str, dict] = {}
    workers: dict[str, dict] = {}

    def wk(labels):
        # a build worker's scrape (serve/worker.py) has no tenant
        # series; its identity is its instance label, or "local" when
        # the scrape came straight off one worker daemon
        return workers.setdefault(labels.get("instance", "local"), {})

    def tn(labels):
        t = labels.get("tenant")
        if t is None:
            return None
        return tenants.setdefault(
            t, {"instances": [], "resident_on": [], "requests": 0.0,
                "window_p99_ms": None, "applied_seqno": 0,
                "cluster": None, "mig": None, "mig_lag": None,
                "seq_drift": None, "reseqs": None, "diverged": None,
                "gc_fsyncs": 0.0, "gc_p50": None, "gc_p99": None,
                "seqlock_retries": None})

    for name, labels, val in samples:
        inst = labels.get("instance")
        # fleet-DERIVED gauges keep their own cluster= label (that is
        # the point of them), so they must not mint the instance row's
        # cluster — the per-member/router series do
        if inst and inst not in instances \
                and not name.startswith("sheep_fleet_"):
            instances[inst] = {"cluster": labels.get("cluster")}
        if inst and inst not in instances:
            continue
        if name == "sheep_serve_epoch" and inst:
            instances[inst]["epoch"] = int(val)
        elif name == "sheep_serve_repl_lag_records" and inst \
                and "node" not in labels:
            instances[inst]["repl_lag"] = int(val)
        elif name == "sheep_process_vmrss_bytes" and inst:
            instances[inst]["vmrss_mb"] = round(val / (1 << 20), 1)
        elif name == "sheep_serve_tenant_resident":
            rec = tn(labels)
            if rec is None:
                continue
            if inst and inst not in rec["instances"]:
                rec["instances"].append(inst)
                if rec["cluster"] is None:
                    rec["cluster"] = labels.get("cluster")
            if val >= 1 and inst:
                rec["resident_on"].append(inst)
        elif name == "sheep_serve_tenant_requests_total":
            rec = tn(labels)
            if rec is not None:
                rec["requests"] += val
        elif name == "sheep_serve_tenant_window_p99_seconds":
            rec = tn(labels)
            if rec is not None:
                ms = round(val * 1000, 3)
                if rec["window_p99_ms"] is None \
                        or ms > rec["window_p99_ms"]:
                    rec["window_p99_ms"] = ms
        elif name == "sheep_serve_tenant_applied_seqno":
            rec = tn(labels)
            if rec is not None:
                rec["applied_seqno"] = max(rec["applied_seqno"],
                                           int(val))
        elif name == "sheep_serve_mig_phase" and val >= 1:
            # migration visibility: a member reporting
            # snap/delta (target adopting in) wins over the source's
            # "moved" when both show up in one scrape
            rec = tn(labels)
            if rec is not None:
                phase = labels.get("phase", "?")
                if rec["mig"] is None or phase != "moved":
                    rec["mig"] = phase
        elif name in ("sheep_serve_mig_delta_lag_records",
                      "sheep_migrate_delta_lag_records"):
            rec = tn(labels)
            if rec is not None:
                rec["mig_lag"] = max(rec["mig_lag"] or 0, int(val))
        elif name == "sheep_diverged":
            # anti-entropy: any instance reporting the
            # tenant quarantined marks the whole tenant row
            rec = tn(labels)
            if rec is not None:
                rec["diverged"] = max(rec["diverged"] or 0, int(val))
        elif name == "sheep_scrub_runs_total" and inst:
            instances[inst]["scrub_runs"] = int(val)
        elif name == "sheep_scrub_quarantined_total" and inst:
            instances[inst]["scrub_quar"] = int(val)
        elif name == "sheep_scrub_repaired_total" and inst:
            instances[inst]["scrub_rep"] = int(val)
        elif name == "sheep_serve_seq_drift":
            rec = tn(labels)
            if rec is not None:
                rec["seq_drift"] = max(rec["seq_drift"] or 0, int(val))
        elif name == "sheep_serve_reseqs_total":
            rec = tn(labels)
            if rec is not None:
                rec["reseqs"] = max(rec["reseqs"] or 0, int(val))
        elif name == "sheep_serve_group_commit_fsyncs_total":
            rec = tn(labels)
            if rec is not None:
                rec["gc_fsyncs"] += val
        elif name == "sheep_serve_group_commit_size_p50":
            rec = tn(labels)
            if rec is not None:
                rec["gc_p50"] = max(rec["gc_p50"] or 0, int(val))
        elif name == "sheep_serve_group_commit_size_p99":
            rec = tn(labels)
            if rec is not None:
                rec["gc_p99"] = max(rec["gc_p99"] or 0, int(val))
        elif name == "sheep_serve_read_seqlock_retries_total":
            rec = tn(labels)
            if rec is not None:
                rec["seqlock_retries"] = (rec["seqlock_retries"] or 0) \
                    + int(val)
        elif name == "sheep_worker_legs_inflight":
            wk(labels)["legs_inflight"] = int(val)
        elif name == "sheep_worker_legs_done":
            wk(labels)["legs_done"] = int(val)
        elif name == "sheep_worker_bytes_shipped":
            wk(labels)["bytes_shipped"] = int(val)
    # a build worker's process gauges ride the same scrape; attach them
    # only to scrapes that identified themselves as workers above
    if workers:
        for name, labels, val in samples:
            key = labels.get("instance", "local")
            if key not in workers:
                continue
            if name == "sheep_process_vmrss_bytes":
                workers[key]["vmrss_mb"] = round(val / (1 << 20), 1)
            elif name == "sheep_process_uptime_seconds":
                workers[key]["uptime_s"] = round(val, 1)
    for rec in tenants.values():
        hosting = [instances.get(i, {}) for i in rec["instances"]]
        rec["repl_lag"] = max((h.get("repl_lag", 0) for h in hosting),
                              default=0)
        rec["epoch"] = max((h.get("epoch", 0) for h in hosting),
                           default=0)
        rec["resident"] = len(rec["resident_on"])
    fleet = {}
    for name, labels, val in samples:
        if name == "sheep_fleet_epoch_skew":
            fleet.setdefault("epoch_skew", {})[
                labels.get("cluster", "?")] = int(val)
        elif name == "sheep_fleet_repl_lag_max_records":
            fleet.setdefault("repl_lag_max", {})[
                labels.get("cluster", "?")] = int(val)
        elif name == "sheep_fleet_members_reachable":
            fleet.setdefault("members_reachable", {})[
                labels.get("cluster", "?")] = int(val)
        elif name == "sheep_fleet_scrape_seconds":
            fleet["scrape_s"] = val
        elif name == "sheep_migrate_inflight":
            fleet["migrate_inflight"] = int(val)
        elif name == "sheep_migrate_completed":
            fleet["migrate_completed"] = int(val)
        elif name == "sheep_migrate_aborted":
            fleet["migrate_aborted"] = int(val)
        elif name == "sheep_rebalance_verdicts_total":
            fleet.setdefault("rebalance_verdicts", {})[
                labels.get("action", "?")] = int(val)
    return {"tenants": tenants, "instances": instances, "fleet": fleet,
            "workers": workers}


def qps_between(prev: dict, cur: dict, dt: float) -> None:
    """Stamp per-tenant qps (and group-commit fsyncs/s) from two views'
    counter deltas."""
    for t, rec in cur["tenants"].items():
        before = prev["tenants"].get(t, {}).get("requests", 0.0)
        rec["qps"] = round(max(0.0, rec["requests"] - before)
                           / max(dt, 1e-9), 1)
        gc0 = prev["tenants"].get(t, {}).get("gc_fsyncs", 0.0)
        rec["fsyncs_per_s"] = round(max(0.0, rec["gc_fsyncs"] - gc0)
                                    / max(dt, 1e-9), 1)


def render_table(view: dict, scrape_bytes: int) -> str:
    # the MIG/DLAG columns only appear while a migration is visible in
    # the scrape (the remote-worker-columns discipline: byte-stable
    # output for fleets that never migrate)
    migrating = any(rec.get("mig") for rec in view["tenants"].values())
    # same discipline for the re-sequence columns: they only
    # appear once a tenant reports sequence drift or a completed reseq
    reseqing = any(rec.get("reseqs") or rec.get("seq_drift")
                   for rec in view["tenants"].values())
    # ...and again for the group-commit write path: the
    # columns appear once a tenant has paid any shared fsync or a
    # lock-free read has retried — an idle fleet's table is unchanged
    committing = any(rec.get("gc_fsyncs") or rec.get("seqlock_retries")
                     for rec in view["tenants"].values())
    # anti-entropy columns: DVRG appears once any tenant is
    # quarantined; the instance table's SCRUB/QUAR/REP appear once any
    # member has completed a scrub pass
    diverging = any(rec.get("diverged")
                    for rec in view["tenants"].values())
    scrubbing = any(rec.get("scrub_runs")
                    for rec in view["instances"].values())
    head = (f"{'TENANT':<12} {'CLUSTER':<8} {'QPS':>8} {'P99w':>9} "
            f"{'LAG':>5} {'EPOCH':>5} {'RES':>4} {'APPLIED':>9}")
    if migrating:
        head += f" {'MIG':>8} {'DLAG':>6}"
    if reseqing:
        head += f" {'SDRIFT':>6} {'RESEQ':>5}"
    if committing:
        head += f" {'FSYN/s':>7} {'GC50':>5} {'GC99':>5} {'SLRT':>6}"
    if diverging:
        head += f" {'DVRG':>4}"
    lines = [head, "-" * len(head)]
    for t, rec in sorted(view["tenants"].items()):
        p99 = rec.get("window_p99_ms")
        row = (
            f"{t:<12} {rec.get('cluster') or '?':<8} "
            f"{rec.get('qps', '-'):>8} "
            f"{(f'{p99:.2f}ms' if p99 is not None else '-'):>9} "
            f"{rec.get('repl_lag', 0):>5} {rec.get('epoch', 0):>5} "
            f"{rec.get('resident', 0):>4} "
            f"{rec.get('applied_seqno', 0):>9}")
        if migrating:
            mlag = rec.get("mig_lag")
            row += (f" {rec.get('mig') or '-':>8} "
                    f"{(mlag if mlag is not None else '-'):>6}")
        if reseqing:
            sd = rec.get("seq_drift")
            rq = rec.get("reseqs")
            row += (f" {(sd if sd is not None else '-'):>6} "
                    f"{(rq if rq is not None else '-'):>5}")
        if committing:
            fps = rec.get("fsyncs_per_s")
            slr = rec.get("seqlock_retries")
            row += (f" {(fps if fps is not None else '-'):>7} "
                    f"{(rec.get('gc_p50') if rec.get('gc_p50') is not None else '-'):>5} "
                    f"{(rec.get('gc_p99') if rec.get('gc_p99') is not None else '-'):>5} "
                    f"{(slr if slr is not None else '-'):>6}")
        if diverging:
            row += f" {('YES' if rec.get('diverged') else '-'):>4}"
        lines.append(row)
    lines.append("")
    ihead = (f"{'INSTANCE':<22} {'CLUSTER':<8} {'EPOCH':>5} "
             f"{'LAG':>5} {'RSS':>9}")
    if scrubbing:
        ihead += f" {'SCRUB':>5} {'QUAR':>4} {'REP':>4}"
    lines += [ihead, "-" * len(ihead)]
    for inst, rec in sorted(view["instances"].items()):
        rss = rec.get("vmrss_mb")
        irow = (
            f"{inst:<22} {rec.get('cluster') or '?':<8} "
            f"{rec.get('epoch', '-'):>5} {rec.get('repl_lag', '-'):>5} "
            f"{(f'{rss}M' if rss is not None else '-'):>9}")
        if scrubbing:
            irow += (f" {rec.get('scrub_runs', '-'):>5} "
                     f"{rec.get('scrub_quar', '-'):>4} "
                     f"{rec.get('scrub_rep', '-'):>4}")
        lines.append(irow)
    if view.get("workers"):
        whead = (f"{'WORKER':<22} {'INFLT':>5} {'DONE':>6} "
                 f"{'SHIPPED':>10} {'RSS':>9}")
        lines += ["", whead, "-" * len(whead)]
        for w, rec in sorted(view["workers"].items()):
            rss = rec.get("vmrss_mb")
            shipped = rec.get("bytes_shipped")
            lines.append(
                f"{w:<22} {rec.get('legs_inflight', '-'):>5} "
                f"{rec.get('legs_done', '-'):>6} "
                f"{(f'{shipped / (1 << 20):.1f}M' if shipped is not None else '-'):>10} "
                f"{(f'{rss}M' if rss is not None else '-'):>9}")
    fleet = view["fleet"]
    foot = [f"scrape: {scrape_bytes} bytes"]
    if "scrape_s" in fleet:
        foot.append(f"fan-in {fleet['scrape_s'] * 1000:.1f}ms")
    if fleet.get("epoch_skew"):
        skews = ", ".join(f"{c}={v}" for c, v in
                          sorted(fleet["epoch_skew"].items()))
        foot.append(f"epoch skew {skews}")
    if fleet.get("migrate_inflight") or fleet.get("migrate_completed") \
            or fleet.get("migrate_aborted"):
        foot.append(f"migrations {fleet.get('migrate_inflight', 0)} "
                    f"live / {fleet.get('migrate_completed', 0)} done "
                    f"/ {fleet.get('migrate_aborted', 0)} aborted")
    if fleet.get("rebalance_verdicts"):
        rv = fleet["rebalance_verdicts"]
        foot.append(f"rebalancer {rv.get('migrate', 0)} go / "
                    f"{rv.get('hold', 0)} hold")
    lines += ["", "  ".join(foot)]
    return "\n".join(lines) + "\n"


def snapshot(addr) -> tuple[dict, int]:
    with ServeClient(addr[0], addr[1], timeout_s=30.0) as c:
        body = c.metrics()
    return fleet_view(parse_prometheus(body)), len(body)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "r:d:i:n:", ["json"])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2
    host_port = state_dir = None
    interval = None
    iters = 0  # 0 = forever (interactive); --json always one shot
    as_json = False
    for o, a in opts:
        if o == "-r":
            host_port = a
        elif o == "-d":
            state_dir = a
        elif o == "-i":
            interval = float(a)
        elif o == "-n":
            iters = int(a)
        elif o == "--json":
            as_json = True
    if args and host_port is None and state_dir is None:
        host_port = args[0]
        args = args[1:]
    if args:
        print(USAGE)
        return 2
    addr = resolve_addr(host_port, state_dir)
    if addr is None:
        print("top: no router address (-r host:port or -d state-dir "
              "with a router.addr/serve.addr)", file=sys.stderr)
        return 1

    if as_json:
        dt = 1.0 if interval is None else interval
        try:
            view, nbytes = snapshot(addr)
            if dt > 0:
                time.sleep(dt)
                view2, nbytes = snapshot(addr)
                qps_between(view, view2, dt)
                view = view2
        except (OSError, ConnectionError) as exc:
            print(f"top: {addr[0]}:{addr[1]} unreachable ({exc})",
                  file=sys.stderr)
            return 1
        view["scrape_bytes"] = nbytes
        json.dump(view, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return 0

    dt = 2.0 if interval is None else max(0.1, interval)
    prev = None
    n = 0
    try:
        while True:
            try:
                view, nbytes = snapshot(addr)
            except (OSError, ConnectionError) as exc:
                print(f"top: {addr[0]}:{addr[1]} unreachable ({exc})",
                      file=sys.stderr)
                return 1
            if prev is not None:
                qps_between(prev, view, dt)
            prev = view
            sys.stdout.write("\x1b[2J\x1b[H" if n else "")
            sys.stdout.write(
                f"sheep top — {addr[0]}:{addr[1]}  "
                f"{time.strftime('%H:%M:%S')}  (refresh {dt:g}s)\n\n")
            sys.stdout.write(render_table(view, nbytes))
            sys.stdout.flush()
            n += 1
            if iters and n >= iters:
                return 0
            time.sleep(dt)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
