"""Drive the routed fleet once as a user would run it: two serve clusters
behind a router whose rebalancer moves a hot tenant live, and check what
it answers.  Host code: no process it starts loads torch.

    python -m sheep_tpu_torch.scripts.fleet_drive run WORK --hot SD \\
        --cut SD2 [--deadline-s 300]

``SD`` is a serve state dir (``serve_drive run`` leaves one) taken over
in place as the hot tenant; ``SD2`` is a smaller one, copied four times
(each cluster's default tenant, a warm and a cold tenant).  The shape is
the reference's FLEETBENCH (scripts/fleetbench.py).  The steps (any
failed check raises, so the exit code is 1):

1. two single-node clusters ``c0`` and ``c1``, each ``python -m
   sheep_tpu_torch.cli.serve -d WORK/<cid>`` (no drift-triggered
   repartition or re-sequence: each node runs those on its own), with
   ``hot`` on the cluster the hash ring gives it (the source), a
   ``warm`` tenant beside it and a ``cold`` one on the other cluster
   (names the ring places there); once every tenant answers at its
   daemon, ``python -m
   sheep_tpu_torch.cli.route -d WORK/router --cluster c0@... --cluster
   c1@...`` with ``SHEEP_REBALANCE=1`` (interval 0.5 s, min qps 2,
   hysteresis 1.2, cooldown 5 s);
2. traffic through the router: single-pair inserts on hot, warm and
   cold with pauses of 0.002, 0.01 and 0.1 s (a refused insert is
   retried, so each acknowledgement is one record), and a reader of
   16-vid ``PART`` batches on hot, each read's latency and answer kept;
3. from the traffic's start the router's scrape is polled every 0.1 s
   until the rebalancer's own verdict has moved hot
   (``sheep_migrate_completed``) and ``FLOOR_S`` of traffic has run, or
   ``deadline-s`` passes; ``python -m sheep_tpu_torch.cli.top --json``
   runs while the migration is in flight (its ``MIG`` column) and once
   after it (the new placement); ``POST_S`` more seconds of traffic go
   through the new home;
4. every tenant's applied seqno at its final owner is its start seqno
   plus its acknowledged inserts; the source answers hot's insert ``ERR
   moved dest=<dst>``; hot's state at the cut (the target's snapshot at
   the sealed seqno) has the source's sealed ``CRC``; every ``PART``
   answer the reader got through the router, before, during and after
   the move, equals the final owner's answer to the same batch asked
   directly (with the drift repartition and the re-sequence held off an
   insert changes no vid's part, and the writers' vids stay below the
   store's ``n``);
5. every process stopped (SIGTERM), ``python -m
   sheep_tpu_torch.cli.fsck`` passes on every state dir.

Prints one ``fleet_record {...}`` line: the checks, the fleet's start
seconds, ``migration_s`` (verdict to done), the snapshot's MB and
seconds (verdict to its landing on the target), the cutover's seconds,
the delta lag polled up to the cutover, the read p99 by 0.5 s window, write and read refusals,
the router's counters, the verdicts by action, and ``plan_migration``'s
priced ``cost_s`` for the records the rebalancer passes it beside its
price for the snapshot's bytes and the measured landing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

#: FLEETBENCH's rebalancer knobs (scripts/fleetbench.py)
REBALANCE_ENV = {"SHEEP_REBALANCE": "1",
                 "SHEEP_REBALANCE_INTERVAL_S": "0.5",
                 "SHEEP_REBALANCE_MIN_QPS": "2",
                 "SHEEP_REBALANCE_HYSTERESIS": "1.2",
                 "SHEEP_REBALANCE_COOLDOWN_S": "5"}
#: each writer's pause between inserts (FLEETBENCH's)
PAUSE_S = {"hot": 0.002, "warm": 0.01, "cold": 0.1}
WINDOW_S = 0.5
READ_BATCH = 16
#: seconds of traffic before the verdict window may close (FLEETBENCH's
#: floor) and after the move
FLOOR_S = 2.0
POST_S = 1.0
#: files a state dir's last daemon left that name its process
VOLATILE = ("serve.addr", "serve.hb", "serve.status.json",
            "serve.status.json.tmp")

_T0 = time.perf_counter()


def _say(msg: str) -> None:
    """A progress line on stderr, with the seconds since the start."""
    sys.stderr.write(f"fleet_drive: {time.perf_counter() - _T0:8.2f}s "
                     f"{msg}\n")
    sys.stderr.flush()


def _wait(cond, what: str, timeout_s: float, poll_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(poll_s)
    raise TimeoutError(f"fleet_drive: {what} not reached in {timeout_s}s")


def _ring_name(prefix: str, cluster: str) -> str:
    """A tenant name the two-cluster ring places on ``cluster``."""
    from ..serve.router import HashRing
    ring = HashRing(["c0", "c1"])
    return next(f"{prefix}{i}" for i in range(256)
                if ring.lookup(f"{prefix}{i}") == cluster)


def _copy_state(src: str, dst: str) -> None:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(*VOLATILE))


def _read_addr(path: str):
    try:
        host, port = open(path).read().split()
        return host, int(port)
    except (OSError, ValueError):
        return None


class Proc:
    """One ``python -m`` process with its log."""

    def __init__(self, name: str, work: str):
        self.name = name
        self.log = os.path.join(work, f"{name}.log")
        self.proc: subprocess.Popen | None = None

    def start(self, argv: list, env: dict) -> "Proc":
        full = dict(os.environ)
        full.update(env)
        with open(self.log, "a") as log:
            self.proc = subprocess.Popen([sys.executable, "-m", *argv],
                                         stdout=log,
                                         stderr=subprocess.STDOUT,
                                         env=full)
        return self

    def stop(self) -> int | None:
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode

    def tail(self) -> str:
        try:
            return open(self.log).read()[-3000:]
        except OSError:
            return ""


def _gauges(addr) -> dict:
    """One router scrape folded to the fleet gauges the drive steers by
    (scripts/fleetbench.py's ``_scrape_gauges``, with the delta lag and
    the tenants' applied seqnos)."""
    from ..obs.metrics import parse_prometheus
    from ..serve.protocol import ServeClient
    out = {"completed": 0, "aborted": 0, "inflight": 0, "verdicts": {},
           "delta_lag": None, "applied": {}}
    with ServeClient(*addr, timeout_s=30) as c:
        samples = parse_prometheus(c.metrics())
    for name, labels, val in samples:
        if name == "sheep_migrate_completed":
            out["completed"] = int(val)
        elif name == "sheep_migrate_aborted":
            out["aborted"] = int(val)
        elif name == "sheep_migrate_inflight":
            out["inflight"] = int(val)
        elif name == "sheep_rebalance_verdicts_total":
            out["verdicts"][labels.get("action", "?")] = int(val)
        elif name == "sheep_migrate_delta_lag_records":
            out["delta_lag"] = int(val)
        elif name == "sheep_serve_tenant_applied_seqno" \
                and labels.get("tenant"):
            t = labels["tenant"]
            out["applied"][t] = max(out["applied"].get(t, 0), int(val))
    return out


def _top(router_dir: str) -> dict:
    """``python -m sheep_tpu_torch.cli.top --json -i 0`` on the router:
    its exit code, wall and view."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.top", "--json", "-i",
         "0", "-d", router_dir], capture_output=True, text=True,
        timeout=120)
    view = json.loads(proc.stdout) if proc.returncode == 0 else None
    return {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "view": view}


def _top_row(top: dict, tenant: str) -> dict:
    """The tenant's row of a ``top --json`` view, less its latency and
    per-instance lists."""
    row = ((top.get("view") or {}).get("tenants") or {}).get(tenant, {})
    return {k: row.get(k) for k in ("cluster", "mig", "mig_lag",
                                    "applied_seqno", "resident")}


def _snapshot_crc(state_dir: str, seqno: int) -> int | None:
    """``state_crc()`` of the store sealed at ``seqno`` in ``state_dir``
    (its snapshot alone, recovered from a copy with an empty log)."""
    from ..serve.state import ServeCore, load_serve_snapshot, snap_name
    from ..serve.wal import create_wal, wal_path
    snap = os.path.join(state_dir, snap_name(seqno))
    if not os.path.exists(snap):
        return None
    with tempfile.TemporaryDirectory(dir=os.path.dirname(state_dir)) as tmp:
        for suffix in ("", ".sum"):
            shutil.copyfile(snap + suffix,
                            os.path.join(tmp, os.path.basename(snap) + suffix))
        head = load_serve_snapshot(snap, "strict")
        create_wal(wal_path(tmp), head.sig, epoch=head.epoch)
        del head
        core = ServeCore.open(tmp)
        try:
            return core.state_crc()
        finally:
            core.close()


def _phase(manifest_file: str) -> str | None:
    """The phase a migration manifest names (None until it exists)."""
    try:
        with open(manifest_file) as f:
            return json.load(f).get("phase")
    except (OSError, ValueError):
        return None


def _manifests(router_dir: str) -> list:
    """Every migration manifest the router left (one per tenant)."""
    from ..serve.migrate import load_manifests
    return load_manifests(router_dir)


def _fsck(paths: list) -> tuple:
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.fsck", *paths],
        capture_output=True, text=True, timeout=900)
    return proc.returncode, proc.stdout + proc.stderr


def run_main(a) -> int:
    """Steps 1-5 (the module docstring); prints the ``fleet_record``."""
    from ..plan.model import plan_migration
    from ..serve.protocol import ServeClient, ServeError
    from ..serve.router import HashRing
    work = os.path.abspath(a.work)
    os.makedirs(work, exist_ok=True)
    checks, rec = {}, {}
    ring = HashRing(["c0", "c1"])
    src = ring.lookup("hot")
    dst = "c1" if src == "c0" else "c0"
    warm, cold = _ring_name("warm", src), _ring_name("cold", dst)
    names = {"hot": "hot", "warm": warm, "cold": cold}
    placement = {"hot": src, warm: src, cold: dst}
    rec.update(src=src, dst=dst, tenants=placement)
    dirs = {"hot": os.path.abspath(a.hot)}
    for key in ("c0", "c1", "warm", "cold"):
        dirs[key] = os.path.join(work, key)
        _copy_state(os.path.abspath(a.cut), dirs[key])
    for name in VOLATILE:
        if os.path.exists(os.path.join(dirs["hot"], name)):
            os.unlink(os.path.join(dirs["hot"], name))
    env = {"SHEEP_SERVE_DRIFT_MIN": str(1 << 40), "SHEEP_RESEQ": "0",
           "SHEEP_SERVE_FAULT_PLAN": "", "SHEEP_SERVE_TENANTS": "",
           "SHEEP_SERVE_NETFAULT_PLAN": ""}
    nodes = {cid: Proc(cid, work) for cid in ("c0", "c1")}
    router = Proc("router", work)
    router_dir = os.path.join(work, "router")
    stop = threading.Event()
    try:
        # 1. the fleet: every tenant answering at its daemon first, so
        # the router's rebalancer starts with the traffic (a verdict
        # taken while the store loads would judge the drive's probes)
        t0 = time.perf_counter()
        for cid, node in nodes.items():
            tflags = []
            for key, t in names.items():
                if placement[t] == cid:
                    tflags += ["--tenant", f"{t}={dirs[key]}"]
            node.start(["sheep_tpu_torch.cli.serve", "-d", dirs[cid],
                        "--node-id", cid, *tflags], env)
        start = {}
        for t, cid in placement.items():
            def answers(t=t, cid=cid):
                addr = _read_addr(os.path.join(dirs[cid], "serve.addr"))
                if addr is None:
                    return None
                try:
                    with ServeClient(*addr, timeout_s=60) as c:
                        c.tenant(t)
                        return c.kv("STATS")
                except (ServeError, OSError):
                    return None
            st = _wait(answers, f"tenant {t} answering at {cid}",
                       a.deadline_s, poll_s=0.2)
            start[t] = {"applied": int(st["applied_seqno"]),
                        "n": int(st["n"])}
        router.start(["sheep_tpu_torch.cli.route", "-d", router_dir,
                      "--cluster", f"c0@{dirs['c0']}",
                      "--cluster", f"c1@{dirs['c1']}"],
                     dict(env, **REBALANCE_ENV))
        raddr = _wait(lambda: _read_addr(os.path.join(router_dir,
                                                      "router.addr")),
                      "router.addr", a.deadline_s)
        rec["fleet_start_s"] = time.perf_counter() - t0
        rec["start"] = start
        _say("fleet up")

        # 2. the traffic
        acked = {t: 0 for t in placement}
        refusals = {"write": 0, "read": 0}
        read_lat: list = []
        read_vids = list(range(0, start["hot"]["n"],
                               max(1, start["hot"]["n"] // 2048)))
        #: batch offset -> every distinct answer the reader got for it
        read_answers: dict = {}
        lock = threading.Lock()

        def writer(tenant, pause_s):
            n = start[tenant]["n"]
            with ServeClient(*raddr, timeout_s=120) as wc:
                wc.tenant(tenant)
                i = 0
                while not stop.is_set():
                    u, v = (11 * i) % n, (29 * i + 3) % n
                    try:
                        wc.insert([(u, v)])
                        acked[tenant] += 1
                        i += 1
                    except (ServeError, ConnectionError, OSError):
                        # a refusal was not applied: the same pair again
                        with lock:
                            refusals["write"] += 1
                        time.sleep(0.02)
                    time.sleep(pause_s)

        def reader():
            vids = read_vids
            with ServeClient(*raddr, timeout_s=120) as rc:
                rc.tenant("hot")
                i = 0
                while not stop.is_set():
                    batch = [vids[(i * READ_BATCH + j) % len(vids)]
                             for j in range(READ_BATCH)]
                    t1 = time.perf_counter()
                    try:
                        parts = tuple(rc.part(batch))
                        read_lat.append((time.monotonic(),
                                         (time.perf_counter() - t1) * 1e3))
                        read_answers.setdefault(
                            i * READ_BATCH % len(vids), set()).add(parts)
                    except (ServeError, ConnectionError, OSError):
                        with lock:
                            refusals["read"] += 1
                        time.sleep(0.02)
                    i += 1

        threads = [threading.Thread(target=writer, args=(
            names[k], PAUSE_S[k]), daemon=True) for k in PAUSE_S]
        threads.append(threading.Thread(target=reader, daemon=True))
        bench_t0 = time.monotonic()
        for th in threads:
            th.start()

        # 3. the rebalancer's own migration, watched from the start of
        # the traffic (its verdicts start with it), waited for past the
        # floor
        verdict_t = snap_t = cut_t = done_t = None
        manifest_file = os.path.join(router_dir, "migrate-hot.json")
        applied_at_verdict = None
        lags: list = []
        tops_during: list = []
        migrated = threading.Event()

        def watch_top():
            # top as a user runs it while the move is in flight, until
            # one view shows hot's MIG column
            while not migrated.is_set():
                tops_during.append(_top(router_dir))
                if _top_row(tops_during[-1], "hot")["mig"]:
                    return

        top_thread = threading.Thread(target=watch_top, daemon=True)
        gauges = _gauges(raddr)
        mig_dir = os.path.join(dirs[dst], "mig-hot")
        deadline = time.monotonic() + a.deadline_s
        while time.monotonic() < deadline:
            g = _gauges(raddr)
            now = time.monotonic()
            if verdict_t is None and g["verdicts"].get("migrate", 0) >= 1:
                verdict_t = now
                applied_at_verdict = gauges["applied"].get("hot")
                top_thread.start()
                _say("rebalancer verdict: migrate")
            if cut_t is None and g["delta_lag"] is not None:
                lags.append(g["delta_lag"])
            if cut_t is None and _phase(manifest_file) in ("cutover",
                                                           "done"):
                cut_t = now
            if snap_t is None and os.path.isdir(mig_dir) and any(
                    n.endswith(".snap") for n in os.listdir(mig_dir)):
                snap_t = now
                _say("snapshot landed on the target")
            gauges = g
            if done_t is None and (g["completed"] >= 1
                                   or g["aborted"] >= 1):
                done_t = now
            if done_t is not None and now - bench_t0 >= FLOOR_S:
                break
            time.sleep(0.1)
        migrated.set()
        if top_thread.is_alive():
            top_thread.join(timeout=120)
        if done_t is None:
            raise AssertionError(f"fleet_drive: no migration within "
                                 f"{a.deadline_s}s: {gauges}")
        _say(f"migration {'done' if gauges['completed'] else 'aborted'}")
        checks["rebalancer_migrated_hot"] = (
            gauges["completed"] == 1 and gauges["aborted"] == 0
            and verdict_t is not None)
        rec["migration_s"] = done_t - verdict_t if verdict_t else None
        rec["verdict_after_s"] = (verdict_t - bench_t0) if verdict_t \
            else None
        rec["snapshot_s"] = (snap_t - verdict_t) if snap_t and verdict_t \
            else None
        rec["cutover_s"] = (done_t - cut_t) if cut_t else None
        # the router's gauge of the target's delta lag, polled up to the
        # driver's entry into the cutover (it enters at
        # SHEEP_MIGRATE_LAG_CUT records and cuts once drained)
        rec["delta_lag_before_cut"] = lags[-1] if lags else None
        rec["delta_lag_max"] = max(lags) if lags else None
        top_after = _top(router_dir)
        time.sleep(POST_S)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        _say("traffic stopped")

        # 4. the checks through the router and at the source
        snaps = [n for n in os.listdir(mig_dir) if n.endswith(".snap")] \
            if os.path.isdir(mig_dir) else []
        rec["migrations"] = _manifests(router_dir)
        manifest = next((m for m in rec["migrations"]
                         if m["tenant"] == "hot"), None)
        if manifest is None:
            raise AssertionError(f"fleet_drive: the rebalancer did not "
                                 f"move hot: {rec['migrations']}")
        sealed = int(manifest["seal_applied"])
        first = min(snaps) if snaps else None
        rec["snapshot_mb"] = os.path.getsize(os.path.join(
            mig_dir, first)) / 2 ** 20 if first else None
        applied = {}
        with ServeClient(*raddr, timeout_s=120) as c:
            for t in placement:
                c.tenant(t)
                applied[t] = int(c.kv("STATS")["applied_seqno"])
            router_stats = c.kv("ROUTER")
        rec["acked"] = dict(acked)
        rec["applied"] = applied
        rec["acked_lost"] = {t: start[t]["applied"] + acked[t] - applied[t]
                             for t in placement}
        checks["acked_equals_applied"] = all(
            v == 0 for v in rec["acked_lost"].values())
        rec["refusals"] = dict(refusals)
        rec["reads"] = len(read_lat)
        rec["router"] = {k: router_stats.get(k) for k in (
            "requests", "reads", "writes", "retries", "reroutes",
            "moved_reroutes", "errors", "insert_unknown",
            "migrations_completed", "migrations_aborted")}
        rec["verdicts"] = gauges["verdicts"]
        windows: dict = {}
        for at, ms in read_lat:
            windows.setdefault(int((at - bench_t0) / WINDOW_S), []).append(ms)
        wp99 = []
        for w in sorted(windows):
            lat = sorted(windows[w])
            wp99.append(lat[min(len(lat) - 1, int(0.99 * len(lat)))])
        rec["window_p99_ms"] = wp99
        rec["worst_window_p99_ms"] = max(wp99) if wp99 else None
        rec["cut_window"] = (int((done_t - bench_t0) / WINDOW_S)
                             if done_t else None)
        saddr = _read_addr(os.path.join(dirs[src], "serve.addr"))
        with ServeClient(*saddr, timeout_s=120) as c:
            src_stat = c.kv("MIG STAT hot")
            c.tenant("hot")
            try:
                c.insert([(1, 2)])
                moved = "acked"
            except ServeError as exc:
                moved = f"{exc.code} {exc.detail}"
        rec["source"] = {"stat": src_stat, "insert": moved}
        # the reader's answers against the final owner's, asked directly
        daddr = _read_addr(os.path.join(dirs[dst], "serve.addr"))
        stale = 0
        with ServeClient(*daddr, timeout_s=120) as c:
            c.tenant("hot")
            for off, seen in read_answers.items():
                batch = [read_vids[(off + j) % len(read_vids)]
                         for j in range(READ_BATCH)]
                stale += len(seen - {tuple(c.part(batch))})
        rec["read_batches_checked"] = len(read_answers)
        rec["read_answers_wrong"] = stale
        checks["reads_equal_final_owner"] = bool(read_answers) and stale == 0
        checks["source_answers_moved"] = moved == f"moved dest={dst}"
        checks["router_rerouted"] = (
            applied["hot"] > sealed
            and router_stats.get("migrations_completed") == 1)
        # the plan's price for what the rebalancer passes it (the
        # tenant's applied seqno as its records), beside its arithmetic
        # (12 bytes a record) over the snapshot the move shipped
        shipped = os.path.getsize(os.path.join(mig_dir, first)) \
            if first else 0
        rec["plan"] = {
            "records_passed": applied_at_verdict,
            "cost_s": plan_migration(applied_at_verdict or 0, 1.0, 2.0,
                                     0.0)["cost_s"],
            "snapshot_bytes": shipped,
            "snapshot_cost_s": plan_migration(shipped // 12, 1.0, 2.0,
                                              0.0)["cost_s"],
            "measured_snapshot_s": rec["snapshot_s"]}

        # top during and after
        during = [_top_row(x, "hot") for x in tops_during]
        rec["top_during"] = during
        rec["top_during_walls_s"] = [x["wall_s"] for x in tops_during]
        after_view = top_after.get("view") or {}
        hot_after = (after_view.get("tenants") or {}).get("hot", {})
        dst_insts = {i for i, row in (after_view.get("instances")
                                      or {}).items()
                     if row.get("cluster") == dst}
        rec["top_after"] = {
            **_top_row(top_after, "hot"),
            "resident_on_dst": sorted(set(hot_after.get("resident_on", []))
                                      & dst_insts),
            "migrate_completed": (after_view.get("fleet") or {}).get(
                "migrate_completed")}
        checks["top_shows_mig"] = any(r["mig"] for r in during)
        checks["top_shows_new_placement"] = (
            top_after["rc"] == 0 and bool(rec["top_after"]["resident_on_dst"])
            and rec["top_after"]["migrate_completed"] == 1)

        # 5. stop, the crc at the cut, fsck
        codes = {n.name: n.stop() for n in [router, *nodes.values()]}
        rec["exit_codes"] = codes
        src_crc = int(src_stat["crc"])
        cut_crc = _snapshot_crc(mig_dir, sealed)
        rec["crc"] = {"source_sealed": src_crc, "target_at_cut": cut_crc,
                      "sealed_seqno": sealed,
                      "source_applied": int(src_stat["applied"])}
        checks["crc_at_cut_equals_source"] = (
            cut_crc == src_crc and int(src_stat["applied"]) == sealed)
        fsck_dirs = [dirs[k] for k in ("c0", "c1", "hot", "warm", "cold")]
        fsck_dirs.append(mig_dir)
        rc, out = _fsck(fsck_dirs)
        lines = [ln for ln in out.splitlines() if ln.strip()]
        rec["fsck"] = {"rc": rc, "lines": len(lines),
                       "fail": [ln for ln in lines
                                if ln.startswith("FAIL")][:4]}
        checks["fsck_clean"] = rc == 0
    except BaseException as exc:
        for p in [router, *nodes.values()]:
            sys.stderr.write(f"--- {p.name} log ---\n{p.tail()}\n")
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["migrations"] = _manifests(router_dir)
        rec["checks"] = checks
        print("fleet_record " + json.dumps(rec), flush=True)
        raise
    finally:
        stop.set()
        for p in [router, *nodes.values()]:
            if p.proc is not None and p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()
    rec["checks"] = checks
    print("fleet_record " + json.dumps(rec), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"fleet_drive: checks failed: {checks}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fleet_drive")
    ap.add_argument("mode", choices=("run",))
    ap.add_argument("work")
    ap.add_argument("--hot", required=True)
    ap.add_argument("--cut", required=True)
    ap.add_argument("--deadline-s", type=float, default=300.0)
    a = ap.parse_args(argv)
    return run_main(a)


if __name__ == "__main__":
    sys.exit(main())
