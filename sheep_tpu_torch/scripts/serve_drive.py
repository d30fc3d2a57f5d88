"""Drive the serve store (``serve.ServeCore``) once at a given size, as a
user would run it, and check what it answers.  Host code: no process it
starts loads torch.

    python -m sheep_tpu_torch.scripts.serve_drive run WORK \\
        --tree T.tre --seq S.seq --graph G.dat [--log-n 23] \\
        [--inserts 65536] [--batch 64] [--kill-at 512] [--query 1024] \\
        [--subtree-every 16] [--reseq-graph G20.dat --reseq-log-n 20]

``run``, the steps (any failed check raises, so the exit code is 1):

1. ``ServeCore.bootstrap`` on the tree and sequence, with the graph's
   ``.dat`` for the baseline ECV and the resident edges, in 2 parts
   (``WORK/sd``);
   a copy of the fresh state dir is kept for the replay (``WORK/replay``);
2. an ``insert`` process (this module) opens the store and inserts the
   ``rmat_edges(log_n, inserts, seed=5)`` stream in batches of ``batch``
   pairs from 4 threads, each batch under its own request id,
   each followed by a ``part_batch`` query of ``query`` vids and every
   ``subtree-every``-th batch of a thread by a ``subtree_batch`` of as
   many (the first after a mutation walks the whole tree under the
   store's lock, so one after every batch would make the run several
   times longer at 2^23; the inserts queued behind those walks set the
   insert p99);
   ``SHEEP_SERVE_FAULT_PLAN=kill@wal:<kill-at - 1>``
   kills it (``os._exit(137)``) right after the covering fsync of its
   ``kill-at``-th insert;
3. a ``resume`` process reopens the store (recovery), checks that every
   acknowledged insert survived, marks the in-flight requests whose
   records the log holds (``client.recovered``, under their request
   ids), retries the others with the same ids and inserts the rest of
   the stream; then the store's WAL records are replayed in seqno order
   into the kept copy, whose ``state_crc()`` must equal the store's;
4. ``seal_snapshot``, then ``serve.reseq.run_reseq(force=True)`` on the
   store, whose new tree must equal ``core.build_forest`` over the graph
   plus the inserts under the new sequence, and on a copy made before
   it a re-sequence killed at ``reseq-fold`` and finished by
   ``resume_reseq``, whose ``state_crc()`` must equal the uninterrupted
   one's (``--reseq-graph``: steps 4 and 5 on a store bootstrapped from
   that graph and given ``rmat_edges(reseq-log-n, inserts, seed=5)`` in
   one thread);
5. ``ecv()`` equal to ``partition.evaluate_partition`` on its parts;
6. ``python -m sheep_tpu_torch.cli.fsck`` as a process on the state
   dir(s): every ``.wal``, ``.snap`` and ``reseq.json`` line passes; a
   copy of the step-3 WAL with one byte flipped mid-chain fails.

The two store processes write their traces to ``WORK/traces``
(``killed.trace``, ``restart.trace``).  Prints one ``serve_record
{...}`` line: the checks, bootstrap seconds, inserts/s with insert p50
and p99 ms per call, queries/s, fsyncs per acknowledged insert, recovery
seconds, reseq seconds with the fold's share, the killed request's id.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ACKS = "acks.log"
THREADS = 4
PARTS = 2
KILLED, RESTART = "killed.trace", "restart.trace"
#: the store keeps every record in its log until the explicit seal, so
#: the replay of step 3 sees the whole stream
SNAP_EVERY = 1 << 40


def rid_of(b: int) -> str:
    return f"5e{b:06x}"


def batches(log_n: int, inserts: int, batch: int) -> np.ndarray:
    """The insert stream, ``[k, batch, 2]`` uint32."""
    from ..utils.synth import rmat_edges
    tail, head = rmat_edges(log_n, inserts, seed=5)
    pairs = np.stack([tail, head], axis=1).astype(np.uint32)
    return pairs.reshape(-1, batch, 2)


def _quantiles(ms: list) -> dict:
    if not ms:
        return {"p50_ms": None, "p99_ms": None}
    s = sorted(ms)
    return {"p50_ms": s[len(s) // 2],
            "p99_ms": s[min(len(s) - 1, int(0.99 * len(s)))]}


def drive(core, stream: np.ndarray, todo: list, a,
          acks_fd: int | None = None) -> dict:
    """Insert the batches ``todo`` from THREADS threads (batch b on
    thread b % THREADS, each thread in order), each batch under
    ``rid_of(b)`` and followed by a ``part_batch`` of ``a.query`` vids,
    every ``a.subtree_every``-th batch of a thread by a ``subtree_batch``
    of as many; ``acks_fd`` gets ``S b`` before and ``A b seqno`` after
    each acknowledged insert, one unbuffered write each.  Returns the
    insert and query times."""
    from ..obs import trace
    ins_ms: list = []
    q_ms: list = []
    s_ms: list = []
    errors: list = []
    lock = threading.Lock()

    def worker(t: int) -> None:
        rng = np.random.default_rng(1000 + t)
        mine, mq, ms = [], [], []
        try:
            for i, b in enumerate(b for b in todo if b % THREADS == t):
                rid = rid_of(b)
                if acks_fd is not None:
                    os.write(acks_fd, f"S {b}\n".encode())
                t0 = time.perf_counter()
                with trace.rid_scope(rid):
                    seqno = core.insert(stream[b], rid=rid)
                mine.append((time.perf_counter() - t0) * 1e3)
                if acks_fd is not None:
                    os.write(acks_fd, f"A {b} {seqno}\n".encode())
                vids = rng.integers(0, 1 << a.log_n, a.query)
                t0 = time.perf_counter()
                core.part_batch(vids)
                mq.append((time.perf_counter() - t0) * 1e3)
                if i % a.subtree_every == 0:
                    t0 = time.perf_counter()
                    core.subtree_batch(vids)
                    ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # noqa: BLE001 - re-raised by the caller
            errors.append(exc)
        with lock:
            ins_ms.extend(mine)
            q_ms.extend(mq)
            s_ms.extend(ms)

    t0 = time.perf_counter()
    pool = [threading.Thread(target=worker, args=(t,))
            for t in range(THREADS)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    def rate(ms: list):
        return len(ms) / (sum(ms) / 1e3) if ms and sum(ms) else None
    return {"inserts": len(ins_ms), "wall_s": wall,
            "inserts_per_s": len(ins_ms) / wall if wall else None,
            **_quantiles(ins_ms), "part_queries": len(q_ms),
            "part_queries_per_s": rate(q_ms),
            "subtree_queries": len(s_ms),
            "subtree_queries_per_s": rate(s_ms),
            "subtree_ms": _quantiles(s_ms)}


def insert_main(a) -> int:
    """Step 2: open and insert until the fault plan kills the process."""
    from ..serve import ServeCore
    stream = batches(a.log_n, a.inserts, a.batch)
    fd = os.open(os.path.join(a.work, ACKS),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        core = ServeCore.open(os.path.join(a.work, "sd"),
                              snap_every=SNAP_EVERY)
        drive(core, stream, list(range(len(stream))), a, fd)
        core.close()
    finally:
        os.close(fd)
    return 0


def _acks(work: str):
    sent, acked = set(), {}
    with open(os.path.join(work, ACKS)) as f:
        for ln in f:
            w = ln.split()
            if len(w) == 2 and w[0] == "S":
                sent.add(int(w[1]))
            elif len(w) == 3 and w[0] == "A":
                acked[int(w[1])] = int(w[2])
    return sent, acked


def resume_main(a) -> int:
    """Step 3: recover, account for the in-flight requests, finish the
    stream; prints one JSON record."""
    from ..obs import trace
    from ..serve import ServeCore, read_wal
    from ..serve.state import encode_inserts
    from ..serve.wal import wal_path
    stream = batches(a.log_n, a.inserts, a.batch)
    sent, acked = _acks(a.work)
    sd = os.path.join(a.work, "sd")
    t0 = time.perf_counter()
    core = ServeCore.open(sd, snap_every=SNAP_EVERY)
    recovery_s = time.perf_counter() - t0
    applied = core.applied_seqno
    _, _, records, _, _ = read_wal(wal_path(sd), "strict")
    logged = {payload for _, payload in records}
    inflight = sorted(sent - set(acked))
    durable = [b for b in inflight if encode_inserts(stream[b]) in logged]
    for b in durable:
        with trace.rid_scope(rid_of(b)):
            trace.event("client.recovered", batch=b, applied=applied)
    retry = [b for b in inflight if b not in durable]
    rest = [b for b in range(len(stream)) if b not in sent] + retry
    ins = drive(core, stream, sorted(rest), a)
    st = core.stats()
    rec = {"recovery_s": recovery_s, "acked_before_kill": len(acked),
           "applied_after_recovery": applied,
           "acked_recovered": all(s <= applied for s in acked.values()),
           "inflight": inflight, "inflight_durable": durable,
           "retried": retry, "resumed": ins, "stats": st,
           "state_crc": core.state_crc()}
    core.close()
    print(json.dumps(rec))
    return 0


def _child(a, mode: str, trace_name: str, env: dict | None = None) -> tuple:
    cmd = [sys.executable, "-m", "sheep_tpu_torch.scripts.serve_drive",
           mode, a.work, "--log-n", str(a.log_n), "--inserts",
           str(a.inserts), "--batch", str(a.batch), "--query",
           str(a.query), "--subtree-every", str(a.subtree_every)]
    full = dict(os.environ)
    full.update(env or {})
    full["SHEEP_TRACE"] = os.path.join(a.work, "traces", trace_name)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=full)
    return proc, time.perf_counter() - t0


def _fsck(paths: list) -> tuple:
    proc = subprocess.run([sys.executable, "-m", "sheep_tpu_torch.cli.fsck",
                           *paths], capture_output=True, text=True)
    return proc.returncode, proc.stdout


def _trace_records(path: str, name: str, kind: str = "span") -> list:
    """The ``kind`` records named ``name`` of a trace (a killed process's
    may end torn)."""
    from ..obs.trace import read_trace
    recs, _, _ = read_trace(path, "repair")
    return [r for r in recs if r.get("k") == kind and r["name"] == name]


def _reseq_store(core, trace_path: str):
    """Step 4 on ``core``: the uninterrupted re-sequence (traced, for its
    fold's share) against the host oracle, then a killed and resumed one
    on a copy made before it."""
    from ..core.forest import build_forest
    from ..obs import trace
    from ..serve import ServeCore, faults, resume_reseq, run_reseq
    sd = core.state_dir
    core.seal_snapshot()
    twin = sd + ".twin"
    shutil.copytree(sd, twin)
    checks, rec = {}, {}
    os.environ["SHEEP_TRACE"] = trace_path
    t0 = time.perf_counter()
    try:
        out = run_reseq(core, force=True)
    finally:
        rec["reseq_s"] = time.perf_counter() - t0
        trace.close_recorder()
        del os.environ["SHEEP_TRACE"]
    fold = sum(r["dur"] for r in _trace_records(trace_path, "reseq.fold"))
    rec["reseq_fold_s"] = fold
    rec["reseq_fold_share"] = fold / rec["reseq_s"]
    rec["reseq"] = out
    tail, head = core._all_edges()
    t0 = time.perf_counter()
    oracle = build_forest(tail, head, core.seq, max_vid=len(core.parts) - 1)
    rec["oracle_s"] = time.perf_counter() - t0
    checks["reseq_gen1"] = out.get("seq_gen") == 1
    checks["reseq_equals_oracle"] = bool(
        np.array_equal(core.parent, oracle.parent)
        and np.array_equal(core.pst, oracle.pst_weight.astype(core.pst.dtype)))
    del oracle
    want_crc = core.state_crc()
    killed = ServeCore.open(twin, snap_every=SNAP_EVERY)
    faults.install_plan(faults.parse_serve_fault_plan(
        "kill@reseq-fold:0", kill_mode="raise"))
    try:
        run_reseq(killed, force=True)
        checks["reseq_killed_at_fold"] = False
    except faults.ServeKilled:
        checks["reseq_killed_at_fold"] = True
    finally:
        faults.clear_plan()
    killed.close()
    t0 = time.perf_counter()
    revived = ServeCore.open(twin, snap_every=SNAP_EVERY)
    resumed = resume_reseq(revived)
    rec["resume_reseq_s"] = time.perf_counter() - t0
    rec["resumed"] = resumed
    checks["resumed_equals_uninterrupted"] = (
        revived.seq_gen == 1 and revived.state_crc() == want_crc)
    revived.close()
    return checks, rec, twin


def _ecv_check(core) -> tuple:
    """Step 5: the store's ECV(down) against the evaluator's."""
    from ..partition.evaluate import evaluate_partition
    tail, head = core._all_edges()
    t0 = time.perf_counter()
    got = core.ecv()["ecv_down"]
    ecv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = evaluate_partition(core.parts, tail, head, core.seq,
                              core.num_parts,
                              max_vid=len(core.parts) - 1).ecv_down
    return got == want, {"ecv_down": got, "ecv_s": ecv_s,
                         "evaluate_s": time.perf_counter() - t0}


def run_main(a) -> int:
    """Steps 1-6 (the module docstring); prints the ``serve_record``."""
    from ..serve import ServeCore, read_wal
    from ..serve.state import decode_inserts
    from ..serve.wal import wal_path
    os.makedirs(os.path.join(a.work, "traces"), exist_ok=True)
    sd = os.path.join(a.work, "sd")
    checks, rec = {}, {}
    stream = batches(a.log_n, a.inserts, a.batch)

    t0 = time.perf_counter()
    core = ServeCore.bootstrap(sd, tre_path=a.tree, seq_path=a.seq,
                               graph_path=a.graph, num_parts=PARTS,
                               snap_every=SNAP_EVERY)
    rec["bootstrap_s"] = time.perf_counter() - t0
    rec["n"], rec["records"] = len(core.seq), len(core.edges_tail)
    core.close()
    shutil.copytree(sd, os.path.join(a.work, "replay"))

    proc, rec["insert_process_s"] = _child(
        a, "insert", KILLED,
        {"SHEEP_SERVE_FAULT_PLAN": f"kill@wal:{a.kill_at - 1}"})
    checks["killed"] = proc.returncode == 137
    if not checks["killed"]:
        raise AssertionError(f"serve: the insert process exited "
                             f"{proc.returncode}, not killed:\n"
                             f"{proc.stderr[-4000:]}")
    sent, acked = _acks(a.work)
    killed_trace = os.path.join(a.work, "traces", KILLED)
    fsyncs = _trace_records(killed_trace, "wal.fsync")
    rec["killed"] = {"acked": len(acked), "sent": len(sent),
                     "fsyncs": len(fsyncs),
                     "fsyncs_per_insert": len(fsyncs) / len(acked)
                     if acked else None}
    proc, rec["resume_process_s"] = _child(a, "resume", RESTART)
    if proc.returncode != 0:
        raise AssertionError(f"serve: the resume process exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["resume"] = res
    checks["no_acked_insert_lost"] = (
        res["acked_recovered"]
        and res["applied_after_recovery"] >= res["acked_before_kill"])
    checks["inflight_durable"] = bool(res["inflight_durable"])
    st = res["stats"]
    checks["whole_stream_applied"] = st["applied_seqno"] == len(stream)
    rec["resume_fsyncs_per_insert"] = (st["gc_fsyncs"] / st["gc_records"]
                                       if st["gc_records"] else None)
    fault = _trace_records(killed_trace, "serve.fault", "ev")
    rec["kill_rid"] = fault[-1].get("rid") if fault else None
    checks["kill_rid_recovered"] = rec["kill_rid"] in {
        rid_of(b) for b in res["inflight_durable"]}

    # the replay: the store's log in seqno order into the kept copy
    core = ServeCore.open(sd, snap_every=SNAP_EVERY)
    checks["reopen_crc"] = core.state_crc() == res["state_crc"]
    wal_copy = os.path.join(a.work, "walcopy")
    os.makedirs(wal_copy)
    shutil.copyfile(wal_path(sd), os.path.join(wal_copy, "serve.wal"))
    _, _, records, _, _ = read_wal(wal_path(sd), "strict")
    replay = ServeCore.open(os.path.join(a.work, "replay"),
                            snap_every=SNAP_EVERY)
    t0 = time.perf_counter()
    for seqno, payload in records:
        if replay.insert(decode_inserts(payload)) != seqno:
            raise AssertionError(f"serve: replay seqno {seqno} out of "
                                 f"order")
    rec["replay_s"] = time.perf_counter() - t0
    checks["replay_crc"] = replay.state_crc() == core.state_crc()
    replay.close()
    shutil.rmtree(os.path.join(a.work, "replay"))

    if a.reseq_graph:
        core.close()
        core = ServeCore.bootstrap(os.path.join(a.work, "sd_cut"),
                                   graph_path=a.reseq_graph,
                                   num_parts=PARTS, snap_every=SNAP_EVERY)
        cut = batches(a.reseq_log_n, a.inserts, a.batch)
        for b in range(len(cut)):
            core.insert(cut[b])
        rec["reseq_store"] = {"n": len(core.seq),
                              "records": len(core.edges_tail)}
    reseq_checks, reseq_rec, twin = _reseq_store(
        core, os.path.join(a.work, "reseq.trace"))
    checks.update(reseq_checks)
    rec.update(reseq_rec)
    ok, ecv_rec = _ecv_check(core)
    checks["ecv_equals_evaluator"] = ok
    rec.update(ecv_rec)
    store = core.state_dir
    core.close()

    rc, out = _fsck([sd, store, twin] if store != sd else [sd, twin])
    lines = [ln for ln in out.splitlines() if ln.strip()]
    kinds = {k: sum(1 for ln in lines if k in ln)
             for k in (".wal", ".snap", "reseq.json")}
    checks["fsck_clean"] = rc == 0 and all(kinds.values())
    rec["fsck_lines"] = kinds
    bad = os.path.join(wal_copy, "serve.wal")
    data = bytearray(open(bad, "rb").read())
    data[len(data) // 2] ^= 0x5A
    with open(bad, "wb") as f:
        f.write(bytes(data))
    rc, out = _fsck([bad])
    checks["fsck_flipped_wal_fails"] = rc == 1 and "FAIL" in out
    rec["checks"] = checks
    print("serve_record " + json.dumps(rec), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"serve: checks failed: {checks}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="serve_drive")
    ap.add_argument("mode", choices=("run", "insert", "resume"))
    ap.add_argument("work")
    ap.add_argument("--tree")
    ap.add_argument("--seq")
    ap.add_argument("--graph")
    ap.add_argument("--reseq-graph")
    ap.add_argument("--reseq-log-n", type=int, default=20)
    ap.add_argument("--log-n", type=int, default=23)
    ap.add_argument("--inserts", type=int, default=1 << 16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kill-at", type=int, default=512)
    ap.add_argument("--query", type=int, default=1 << 10)
    ap.add_argument("--subtree-every", type=int, default=16)
    a = ap.parse_args(argv)
    return {"run": run_main, "insert": insert_main,
            "resume": resume_main}[a.mode](a)


if __name__ == "__main__":
    sys.exit(main())
