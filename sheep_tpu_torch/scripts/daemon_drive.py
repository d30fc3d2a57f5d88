"""Drive the serve daemon as a replicated cluster of processes once, as a
user would run it, and check what it answers.  Host code: no process it
starts loads torch.

    python -m sheep_tpu_torch.scripts.daemon_drive run WORK --state SD \\
        [--tenant-dir SD2] [--log-n 23] [--inserts 16384] [--batch 64] \\
        [--kill-at 128] [--query 1024] [--verify-n 256]

``SD`` is a serve state dir (``serve_drive run`` leaves one); the
cluster takes it over.  The steps (any failed check raises, so the exit
code is 1):

1. a leader ``python -m sheep_tpu_torch.cli.serve -d SD --role leader
   --peers WORK/f1,WORK/f2`` (``SHEEP_SERVE_REPL_ACKS=1``; no
   drift-triggered repartition or re-sequence, which would keep the
   replicas' ``state_crc()`` apart at the quiesce; the second
   tenant ``cut=SD2`` with ``SHEEP_SERVE_MAX_RESIDENT=1``, and
   ``SHEEP_SERVE_FAULT_PLAN=kill@insert:<kill-at - 1>``), then two
   followers with empty state dirs, which bootstrap over the wire
   (``REPL SNAPSHOT``);
2. the tenant: ``PART`` of ``query`` vids on tenant ``cut``, ``EVICT
   cut``, the same ``PART`` again (a lazy restore): equal answers and
   ``CRC``;
3. the load: ``rmat_edges(log_n, inserts, seed=7)`` in batches of
   ``batch`` pairs from 4 ``ServeClient`` threads against the leader,
   beside ``PART`` queries of ``query`` vids to the followers (bounded
   by ``SHEEP_SERVE_MAX_LAG``); the fault plan kills the leader at its
   ``kill-at``-th insert, a follower is elected, and the clients follow
   ``ERR notleader`` and connection loss to it; the killed node
   restarts as a follower, is fenced and catches up;
4. every acknowledged insert is in the new leader's WAL chain
   (``read_wal``) with its payload; after quiescing, the three nodes'
   ``applied_seqno`` and ``CRC`` agree, and ``supervise --status
   --json`` on each state dir reports roles, epochs and seqnos that
   agree;
5. anti-entropy: ``SCRUB`` on the leader; ``CORRUPT`` on a follower
   (``SHEEP_SCRUB_ALLOW_CORRUPT=1``), inserts until its next ``VERIFY``
   frame (every ``verify-n`` records) quarantines it; its reads answer
   ``ERR diverged`` meanwhile; it heals to the leader's ``CRC``; fsck of
   its quarantine marker reports the dir quarantined;
6. every node stopped (SIGTERM), ``python -m sheep_tpu_torch.cli.fsck``
   passes on each state dir (the leader's ``scrub.json`` chain
   included).

Prints one ``daemon_record {...}`` line: the checks, each follower's
bootstrap seconds and snapshot MB, inserts/s, insert p50/p99 ms per
call, follower reads/s, replication lag p99 in records, the failover
seconds (the kill to the first acknowledged insert at the new leader),
the ex-leader's catch-up seconds, and the seconds to detect and to heal
the divergence.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

THREADS = 4
#: every node keeps its whole log until a promotion or a heal seals it,
#: so step 4 reads every acknowledged insert back from the WAL chain
SNAP_EVERY = 1 << 40
DEADLINE_S = 300.0


def _wait(cond, what: str, timeout_s: float = DEADLINE_S,
          poll_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(poll_s)
    raise TimeoutError(f"daemon_drive: {what} not reached in {timeout_s}s")


_T0 = time.perf_counter()


def _say(msg: str) -> None:
    """A progress line on stderr, with the seconds since the start."""
    sys.stderr.write(f"daemon_drive: {time.perf_counter() - _T0:8.2f}s "
                     f"{msg}\n")
    sys.stderr.flush()


def _quantiles(ms: list) -> dict:
    if not ms:
        return {"p50_ms": None, "p99_ms": None}
    s = sorted(ms)
    return {"p50_ms": s[len(s) // 2],
            "p99_ms": s[min(len(s) - 1, int(0.99 * len(s)))]}


class Node:
    """One ``cli.serve`` process and its state dir."""

    def __init__(self, name: str, state_dir: str, work: str):
        self.name = name
        self.state_dir = state_dir
        self.log = os.path.join(work, f"{name}.log")
        self.proc: subprocess.Popen | None = None
        self.started = 0.0

    def start(self, role: str, peers: list, env: dict,
              extra: tuple = ()) -> "Node":
        full = dict(os.environ)
        full.update(env)
        addr = os.path.join(self.state_dir, "serve.addr")
        if os.path.exists(addr):
            os.unlink(addr)  # a killed incarnation's port
        self.started = time.perf_counter()
        with open(self.log, "a") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "sheep_tpu_torch.cli.serve",
                 "-d", self.state_dir, "--role", role, "--peers",
                 ",".join(peers), "--node-id", self.name, *extra],
                stdout=log, stderr=subprocess.STDOUT, env=full)
        return self

    def addr(self):
        try:
            host, port = open(os.path.join(self.state_dir,
                                           "serve.addr")).read().split()
            return host, int(port)
        except (OSError, ValueError):
            return None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def client(self, timeout_s: float = 30.0):
        from ..serve.protocol import ServeClient
        return ServeClient(*self.addr(), timeout_s=timeout_s)

    def kv(self, verb: str, timeout_s: float = 30.0) -> dict:
        with self.client(timeout_s) as c:
            return c.kv(verb)

    def up(self) -> bool:
        if not self.alive() or self.addr() is None:
            return False
        try:
            self.kv("STATS", timeout_s=5.0)
            return True
        except Exception:  # noqa: BLE001 - not up yet
            return False

    def stop(self) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def tail(self) -> str:
        try:
            return open(self.log).read()[-3000:]
        except OSError:
            return ""


class Cluster:
    """The nodes, and which of them is the leader as the clients see
    it."""

    def __init__(self, nodes: list):
        self.nodes = nodes
        self.lock = threading.Lock()
        self.leader = nodes[0]

    def by_addr(self, addr: str):
        for n in self.nodes:
            a = n.addr()
            if a is not None and f"{a[0]}:{a[1]}" == addr:
                return n
        return None

    def find_leader(self, avoid=None):
        """The live node that answers ``role=leader`` with the highest
        epoch (None while there is none)."""
        best = None
        for n in self.nodes:
            if n is avoid or not n.alive() or n.addr() is None:
                continue
            try:
                st = n.kv("STATS", timeout_s=5.0)
            except Exception:  # noqa: BLE001 - down or starting
                continue
            if st.get("role") == "leader" and (
                    best is None or st["epoch"] > best[1]["epoch"]):
                best = (n, st)
        return best[0] if best else None


def _client_loop(cluster: Cluster, stream, todo: list, acks: list,
                 lat: list, errors: list, lock) -> None:
    """Insert ``todo``'s batches in order against the leader, following
    ``ERR notleader`` and connection loss; log each acknowledgement as
    (batch, seqno, leader name, monotonic time)."""
    from ..serve.protocol import ServeError
    conn, node = None, None
    for b in todo:
        deadline = time.monotonic() + DEADLINE_S
        while True:
            if time.monotonic() > deadline:
                errors.append(f"batch {b}: no leader acknowledged it")
                return
            with cluster.lock:
                target = cluster.leader
            if conn is None or node is not target:
                if conn is not None:
                    conn.close()
                conn, node = None, target
                try:
                    conn = target.client()
                except OSError:
                    time.sleep(0.05)
                    _refresh_leader(cluster, target)
                    continue
            t0 = time.perf_counter()
            try:
                seqno = conn.insert(stream[b].tolist())
            except ServeError as exc:
                if exc.code == "notleader":
                    nxt = cluster.by_addr(exc.detail.strip())
                    with cluster.lock:
                        if nxt is not None:
                            cluster.leader = nxt
                    if nxt is None:
                        time.sleep(0.05)
                        _refresh_leader(cluster, target)
                    continue
                if exc.code in ("unavailable", "overload", "timeout"):
                    time.sleep(0.05)
                    continue
                errors.append(f"batch {b}: {exc}")
                return
            except (OSError, ConnectionError):
                conn.close()
                conn = None
                time.sleep(0.05)
                _refresh_leader(cluster, target)
                continue
            now = time.monotonic()
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                acks.append((b, seqno, node.name, now))
            break
    if conn is not None:
        conn.close()


def _refresh_leader(cluster: Cluster, dead) -> None:
    found = cluster.find_leader(avoid=dead if not dead.alive() else None)
    if found is not None:
        with cluster.lock:
            cluster.leader = found


def _reader_loop(node: Node, log_n: int, query: int, stop, out: dict,
                 seed: int) -> None:
    """``PART`` queries of ``query`` vids to one follower until
    ``stop``; counts answers, ``stale`` and ``diverged`` refusals."""
    from ..serve.protocol import ServeError
    rng = np.random.default_rng(seed)
    conn = None
    while not stop.is_set():
        vids = rng.integers(0, 1 << log_n, query).tolist()
        try:
            if conn is None:
                conn = node.client(timeout_s=30.0)
            t0 = time.perf_counter()
            conn.part(vids)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        except ServeError as exc:
            out[exc.code] = out.get(exc.code, 0) + 1
            time.sleep(0.01)
        except (OSError, ConnectionError):
            out["conn_lost"] = out.get("conn_lost", 0) + 1
            conn = None
            time.sleep(0.05)
    if conn is not None:
        conn.close()


def _lost_acks(state_dir: str, acks: list, stream) -> list:
    """The acknowledged batches a node's state dir does not hold: each
    acknowledged (batch, seqno) must be the record of that seqno in the
    WAL chain (``read_wal`` over the archived and current logs) with the
    batch's payload, or, at or below the newest snapshot's seqno (a seal
    starts a fresh log), its pairs must be among the snapshot's
    inserted edges."""
    from collections import Counter
    from ..serve.state import encode_inserts, load_serve_snapshot, snap_paths
    from ..serve.wal import archived_wal_paths, read_wal, wal_path
    wal = {}
    for path in archived_wal_paths(state_dir) + [wal_path(state_dir)]:
        for seqno, payload in read_wal(path, "strict")[2]:
            wal[seqno] = payload
    snap = load_serve_snapshot(snap_paths(state_dir)[-1], "strict")
    lost, sealed = [], Counter()
    for b, seqno, *_ in acks:
        if seqno in wal:
            if wal[seqno] != encode_inserts(stream[b]):
                lost.append(b)
        elif seqno <= snap.applied_seqno:
            sealed.update(map(tuple, stream[b].tolist()))
        else:
            lost.append(b)
    held = Counter(zip(snap.ins_tail.tolist(), snap.ins_head.tolist()))
    if sealed - held:
        lost.append("sealed pairs missing from the snapshot")
    return lost


def _status_json(state_dir: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.supervise", "--status",
         "--json", "-d", state_dir], capture_output=True, text=True,
        timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"daemon_drive: supervise --status on "
                             f"{state_dir} exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def _fsck(paths: list) -> tuple:
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.fsck", *paths],
        capture_output=True, text=True, timeout=900)
    return proc.returncode, proc.stdout + proc.stderr


def run_main(a) -> int:
    """Steps 1-6 (the module docstring); prints the ``daemon_record``."""
    from ..utils.synth import rmat_edges
    work = os.path.abspath(a.work)
    os.makedirs(work, exist_ok=True)
    checks, rec = {}, {}
    lead = Node("L", os.path.abspath(a.state), work)
    f1 = Node("F1", os.path.join(work, "f1"), work)
    f2 = Node("F2", os.path.join(work, "f2"), work)
    nodes = [lead, f1, f2]
    dirs = [n.state_dir for n in nodes]
    # the drift-triggered background rebuilds are held off: a
    # repartition is each node's own (the partition is not replicated)
    # and a re-sequence lands on the followers later than on the leader,
    # so either would keep the replicas' state_crc apart at the quiesce
    # (the serve phase measures the re-sequence)
    base_env = {"SHEEP_SERVE_REPL_ACKS": "1",
                "SHEEP_SERVE_DRIFT_MIN": str(SNAP_EVERY),
                "SHEEP_RESEQ": "0",
                "SHEEP_SERVE_SNAP_EVERY": str(SNAP_EVERY),
                "SHEEP_SCRUB_VERIFY_N": str(a.verify_n),
                "SHEEP_SERVE_FAILOVER_S": str(a.failover_s),
                "SHEEP_SERVE_REPL_HB_S": "0.2",
                "SHEEP_SERVE_MAX_LAG": str(a.max_lag),
                "SHEEP_SCRUB_ALLOW_CORRUPT": "1",
                "SHEEP_SERVE_FAULT_PLAN": "", "SHEEP_SERVE_TENANTS": "",
                "SHEEP_SERVE_MAX_RESIDENT": ""}
    peers = lambda me: [d for d in dirs if d != me.state_dir]  # noqa: E731
    cluster = Cluster(nodes)
    stop, qstop = threading.Event(), threading.Event()
    try:
        # 1. the cluster
        lead_env = dict(base_env,
                        SHEEP_SERVE_FAULT_PLAN=f"kill@insert:{a.kill_at - 1}",
                        SHEEP_SERVE_MAX_RESIDENT="1")
        extra = ("--tenant", f"cut={os.path.abspath(a.tenant_dir)}") \
            if a.tenant_dir else ()
        t0 = time.perf_counter()
        lead.start("leader", peers(lead), lead_env, extra)
        _wait(lead.up, "the leader answering")
        rec["leader_start_s"] = time.perf_counter() - t0
        _say("leader up")
        for f in (f1, f2):
            f.start("follower", peers(f), base_env)
        boots = {}
        for f in (f1, f2):
            _wait(f.up, f"{f.name} answering")
            snaps = [n for n in os.listdir(f.state_dir)
                     if n.endswith(".snap")]
            boots[f.name] = {
                "bootstrap_s": time.perf_counter() - f.started,
                "snapshot_mb": sum(os.path.getsize(os.path.join(
                    f.state_dir, n)) for n in snaps) / 2 ** 20}
        _wait(lambda: lead.kv("STATS").get("followers") == 2,
              "both followers attached")
        rec["bootstrap"] = boots
        _say("followers attached")
        st = lead.kv("STATS")
        rec["n"], rec["start_seqno"] = st["n"], st["applied_seqno"]

        # 2. the tenant: evict and restore answer the same
        if a.tenant_dir:
            rng = np.random.default_rng(3)
            with lead.client() as c:
                c.tenant("cut")
                vids = rng.integers(0, 1 << a.tenant_log_n,
                                    a.query).tolist()
                before = (c.part(vids), c.kv("CRC")["crc"])
                ev = c.kv("EVICT cut")
                t1 = time.perf_counter()
                after = (c.part(vids), c.kv("CRC")["crc"])
                rec["tenant"] = {"evict": ev,
                                 "restore_s": time.perf_counter() - t1,
                                 "resident_after":
                                     c.kv("STATS").get("tenants_resident")}
            checks["tenant_restore_equal"] = before == after

        # 3. the load, the kill, the failover, the ex-leader's return
        tail, head = rmat_edges(a.log_n, a.inserts, seed=7)
        stream = np.stack([tail, head], axis=1).astype(np.uint32) \
            .reshape(-1, a.batch, 2)
        acks, lat, errors = [], [], []
        lock = threading.Lock()
        reads = {f.name: {"ms": []} for f in (f1, f2)}
        readers = [threading.Thread(target=_reader_loop, args=(
            f, a.log_n, a.query, stop, reads[f.name], 100 + i),
            daemon=True) for i, f in enumerate((f1, f2))]
        lags: list = []
        watch: dict = {}

        def monitor():
            while not stop.is_set():
                if "kill_t" not in watch and not lead.alive():
                    watch["kill_t"] = time.monotonic()
                    watch["kill_rc"] = lead.proc.returncode
                with cluster.lock:
                    cur = cluster.leader
                try:
                    st = cur.kv("STATS", timeout_s=5.0)
                    if st.get("role") == "leader":
                        lags.append(int(st.get("repl_lag", 0)))
                except Exception:  # noqa: BLE001 - mid-failover
                    pass
                time.sleep(0.02)

        mon = threading.Thread(target=monitor, daemon=True)
        pool = [threading.Thread(target=_client_loop, args=(
            cluster, stream, list(range(t, len(stream), THREADS)), acks,
            lat, errors, lock), daemon=True) for t in range(THREADS)]
        t0 = time.perf_counter()
        for th in readers + [mon] + pool:
            th.start()
        # the killed leader returns as a follower once a successor leads
        _wait(lambda: "kill_t" in watch, "the leader's kill")
        new = _wait(lambda: cluster.find_leader(avoid=lead),
                    "a follower elected")
        rec["elected"] = new.name
        _say("new leader elected")
        lead.start("follower", peers(lead), base_env)
        restart_t = time.perf_counter()
        for th in pool:
            th.join()
        load_wall = time.perf_counter() - t0
        _say("load done")
        stop.set()
        for th in readers + [mon]:
            th.join()
        if errors:
            raise AssertionError(f"daemon_drive: clients failed: "
                                 f"{errors[:4]}")
        checks["leader_killed"] = watch.get("kill_rc") == 137
        after_kill = [t for _, _, n, t in acks
                      if n != "L" and t >= watch["kill_t"]]
        rec["failover_s"] = (min(after_kill) - watch["kill_t"]
                             if after_kill else None)
        rec["load"] = {"batches": len(acks), "batch": a.batch,
                       "wall_s": load_wall,
                       "inserts_per_s": len(acks) * a.batch / load_wall,
                       "batches_per_s": len(acks) / load_wall,
                       **_quantiles(lat),
                       "acked_by_killed_leader":
                           sum(1 for _, _, n, _ in acks if n == "L")}
        rec["follower_reads"] = {
            name: {"answered": len(r["ms"]),
                   "reads_per_s": len(r["ms"]) / load_wall,
                   **_quantiles(r["ms"]),
                   **{k: v for k, v in r.items() if k != "ms"}}
            for name, r in reads.items()}
        s = sorted(lags)
        rec["repl_lag_p99_records"] = s[min(len(s) - 1,
                                            int(0.99 * len(s)))] \
            if s else None
        checks["every_batch_acked"] = sorted(b for b, *_ in acks) == \
            list(range(len(stream)))

        # 4. quiesce: equal seqnos and crcs, acks in the WAL, --status
        lead_node = cluster.find_leader()
        target = lead_node.kv("STATS")["applied_seqno"]
        _wait(lambda: lead.up() and lead.kv("STATS")["applied_seqno"]
              >= target, "the ex-leader caught up")
        rec["catchup_s"] = time.perf_counter() - restart_t
        _say("ex-leader caught up")
        _wait(lambda: len({n.kv("STATS")["applied_seqno"]
                           for n in nodes}) == 1, "the nodes quiescing")
        crcs = {n.name: n.kv("CRC") for n in nodes}
        checks["equal_crc"] = len({c["crc"] for c in crcs.values()}) == 1
        checks["equal_seqno"] = len({c["seqno"] for c in crcs.values()}) \
            == 1
        rec["crcs"] = crcs
        lost = _lost_acks(lead_node.state_dir, acks, stream)
        checks["no_acked_insert_lost"] = not lost
        rec["acked_not_in_wal"] = lost[:8]
        status = {n.name: _status_json(n.state_dir) for n in nodes}
        rec["status"] = {k: {f: v.get(f) for f in (
            "alive", "role", "epoch", "applied_seqno", "leader")}
            for k, v in status.items()}
        roles = sorted(v["role"] for v in status.values())
        checks["status_agrees"] = (
            roles == ["follower", "follower", "leader"]
            and all(v["alive"] for v in status.values())
            and len({v["epoch"] for v in status.values()}) == 1
            and len({v["applied_seqno"] for v in status.values()}) == 1)

        # 5. anti-entropy
        with lead_node.client() as c:
            rec["scrub"] = c.kv("SCRUB")
        _say("scrubbed")
        checks["scrub_chain"] = os.path.exists(
            os.path.join(lead_node.state_dir, "scrub.json"))
        victim = next(n for n in nodes if n is not lead_node)
        quar: dict = {}

        def quarantine_reads():
            from ..serve.protocol import ServeError
            marker = os.path.join(victim.state_dir, "quarantine.json")
            while not qstop.is_set():
                if "marker" not in quar and os.path.exists(marker):
                    try:
                        quar["marker"] = open(marker).read()
                    except OSError:
                        pass
                try:
                    with victim.client(timeout_s=10.0) as c:
                        c.part([0, 1, 2])
                except ServeError as exc:
                    quar[exc.code] = quar.get(exc.code, 0) + 1
                    quar.setdefault("first_t", time.perf_counter())
                except OSError:
                    pass
                time.sleep(0.002)

        heals0 = victim.kv("STATS").get("quarantine_heals", 0)

        def caught() -> bool:
            st = victim.kv("STATS")
            return (st.get("diverged") == 1
                    or st.get("quarantine_heals", 0) > heals0)

        with victim.client() as c:
            corrupt = c.kv("CORRUPT")
        t_corrupt = time.perf_counter()
        qt = threading.Thread(target=quarantine_reads, daemon=True)
        qt.start()
        rng = np.random.default_rng(29)
        detected = None
        with lead_node.client() as c:
            for _ in range(4 * a.verify_n):
                u, v = (int(x) for x in rng.integers(0, 1 << a.log_n, 2))
                c.insert([(u, v)])
                if caught():
                    detected = time.perf_counter()
                    break
        if detected is None:
            _wait(caught, "the divergence detected", timeout_s=60)
            detected = time.perf_counter()
        detected = min(detected, quar.get("first_t", detected))
        leader_crc = lambda: lead_node.kv("CRC")  # noqa: E731
        _wait(lambda: victim.kv("STATS").get("diverged") == 0
              and victim.kv("STATS").get("quarantine_heals", 0) > heals0
              and victim.kv("CRC") == leader_crc(), "the heal")
        healed = time.perf_counter()
        _say("healed")
        qstop.set()
        qt.join()
        rec["divergence"] = {"victim": victim.name, "corrupt": corrupt,
                             "detect_s": detected - t_corrupt,
                             "heal_s": healed - detected,
                             "reads_refused": quar.get("diverged", 0),
                             "heals": victim.kv("STATS").get(
                                 "quarantine_heals")}
        checks["divergence_detected"] = True
        checks["diverged_reads_refused"] = quar.get("diverged", 0) >= 1
        checks["healed_to_leader_crc"] = True
        if "marker" in quar:
            qdir = os.path.join(work, "quar")
            os.makedirs(qdir, exist_ok=True)
            with open(os.path.join(qdir, "quarantine.json"), "w") as f:
                f.write(quar["marker"])
            rc, out = _fsck([qdir])
            rec["fsck_quarantine"] = out.strip().splitlines()[-1:]
            checks["fsck_reports_quarantine"] = (
                rc == 0 and "dir quarantined: phase=" in out)
        else:
            checks["fsck_reports_quarantine"] = False

        # 6. stop, then fsck every state dir
        for n in nodes:
            n.stop()
        rc, out = _fsck(dirs)
        lines = [ln for ln in out.splitlines() if ln.strip()]
        rec["fsck"] = {"rc": rc, "lines": len(lines),
                       "scrub_chain": sum("chain-ok" in ln for ln in lines),
                       "fail": [ln for ln in lines
                                if ln.startswith("FAIL")][:4]}
        checks["fsck_clean"] = rc == 0 and rec["fsck"]["scrub_chain"] >= 1
    except BaseException:
        for n in nodes:
            try:
                st = n.kv("STATS", timeout_s=5.0) if n.alive() else "down"
            except Exception as exc:  # noqa: BLE001 - the report only
                st = f"no answer ({exc})"
            sys.stderr.write(f"--- {n.name} log ---\n{n.tail()}\n"
                             f"--- {n.name} STATS: {st}\n")
        raise
    finally:
        stop.set()
        qstop.set()
        for n in nodes:
            if n.proc is not None and n.proc.poll() is None:
                n.proc.kill()
                n.proc.wait()
    rec["checks"] = checks
    print("daemon_record " + json.dumps(rec), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"daemon_drive: checks failed: {checks}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="daemon_drive")
    ap.add_argument("mode", choices=("run",))
    ap.add_argument("work")
    ap.add_argument("--state", required=True)
    ap.add_argument("--tenant-dir")
    ap.add_argument("--tenant-log-n", type=int, default=20)
    ap.add_argument("--log-n", type=int, default=23)
    ap.add_argument("--inserts", type=int, default=1 << 14)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kill-at", type=int, default=128)
    ap.add_argument("--query", type=int, default=1 << 10)
    ap.add_argument("--verify-n", type=int, default=256)
    ap.add_argument("--failover-s", type=float, default=2.0)
    ap.add_argument("--max-lag", type=int, default=4096)
    a = ap.parse_args(argv)
    return run_main(a)


if __name__ == "__main__":
    sys.exit(main())
