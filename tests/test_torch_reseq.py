"""The port's crash-safe re-sequence job (sheep_tpu_torch.serve.reseq),
its pricing (plan_reseq, priors.fold_bps) and fsck's generation chain
against the reference's.

The twins of tests/test_reseq.py's single-node tests: the incremental
degree histogram's parity across snapshot restore and WAL replay, the
sequence-drift detector, a kill at every re-sequence boundary resumed
bit-identical, a kill after the seal, and the fsck chain (sanctions, a
torn mid-swap log); and of tests/test_plan.py's
``test_plan_reseq_learns_fold_throughput``.  Each scenario runs through
both packages in turn in the same work dir beside one shared graph, and
the two must hold equal: ``state_crc()``, the results and events, every
state-dir file's bytes (snapshots, WAL, ``reseq.json``) and fsck's
lines."""

import importlib
import os
import shutil
import warnings

import numpy as np
import pytest

from sheep_tpu.io.edges import write_dat
from sheep_tpu.utils.synth import rmat_edges

PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
SITES = ("reseq-hist", "reseq-fold", "reseq-swap", "reseq-seal",
         "ext-boundary")


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("SHEEP_SERVE_FAULT_PLAN", "SHEEP_IO_FAULT_PLAN",
              "SHEEP_EXT_BLOCK", "SHEEP_MEM_BUDGET", "SHEEP_PLAN_PRIORS",
              "SHEEP_RESEQ_PIN", "SHEEP_RESEQ_HORIZON_S", "SHEEP_TRACE",
              "SHEEP_TRACE_MAX_MB"):
        monkeypatch.delenv(k, raising=False)

    def clear():
        for side in PKGS:
            mod(side, "io.faultfs").clear_plan()
            mod(side, "serve.faults").clear_plan()
            rt = mod(side, "runtime")
            rt.clear_plan()
            rt.reset_counters()
    clear()
    yield monkeypatch
    clear()


def dir_bytes(d: str) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in sorted(files):
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def fsck(side, paths, mode="strict"):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results, failures = mod(side, "integrity.fsck").fsck_paths(paths,
                                                                    mode)
    return results, len(failures)


def state(side, tmp_path, name="state", seed=3, log2=7, parts=3, **kw):
    tail, head = rmat_edges(log2, 4 << log2, seed=seed)
    g = str(tmp_path / f"g{seed}-{log2}.dat")
    if not os.path.exists(g):
        write_dat(g, tail, head)
    sd = str(tmp_path / "work" / name)
    core = mod(side, "serve").ServeCore.bootstrap(sd, graph_path=g,
                                                  num_parts=parts, **kw)
    return core, sd, tail, head


def both(tmp_path, fn):
    got = {}
    for side in PKGS:
        shutil.rmtree(tmp_path / "work", ignore_errors=True)
        (tmp_path / "work").mkdir()
        got[side] = fn(side)
    assert got["port"] == got["ref"]
    return got["port"]


def skewed_inserts(k, lo=200, span=6, seed=9):
    rng = np.random.default_rng(seed)
    hub = lo + rng.integers(0, span, size=k)
    other = rng.integers(0, lo, size=k)
    return np.stack([hub, other], axis=1).astype(np.uint32)


def test_degree_histogram_parity_equals_reference(tmp_path):
    def run(side):
        core, sd, tail, head = state(side, tmp_path, snap_every=10)
        rng = np.random.default_rng(21)
        parity = []
        for _ in range(6):
            k = int(rng.integers(1, 9))
            for row in rng.integers(0, 200, (k, 2)).astype(np.uint32):
                core.insert(row.reshape(1, 2))
            parity.append(core.degree_parity())
        counts = core.recount_degrees().tolist()
        crc, applied = core.state_crc(), core.applied_seqno
        core.close()
        again = mod(side, "serve").ServeCore.open(sd)
        out = (parity, counts, crc, applied, again.degree_parity(),
               again.state_crc(), again.applied_seqno)
        again.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    assert all(got[0][0]) and got[0][4]
    assert got[0][2:4] == got[0][5:7]


def test_seq_drift_detector_equals_reference(tmp_path):
    def run(side):
        core, _, _, _ = state(side, tmp_path, reseq_min=8, reseq_frac=0.25)
        before = core.seq_drift_exceeded()
        for row in skewed_inserts(24):
            core.insert(row.reshape(1, 2))
        out = (before, core.seq_drift, core.seq_drift_exceeded(),
               core.stats(), core.ecv())
        core.close()
        return out
    got = both(tmp_path, run)
    assert not got[0] and got[1] > 0 and got[2]
    assert got[3]["seq_drift"] == got[1] and got[4]["reseqs"] == 0


def _control(side, tmp_path, ins):
    core, sd, _, _ = state(side, tmp_path, name="ref")
    for row in ins:
        core.insert(row.reshape(1, 2))
    core.close()
    base = str(tmp_path / "work" / "base")
    shutil.copytree(sd, base)
    control = mod(side, "serve").ServeCore.open(sd)
    res = mod(side, "serve.reseq").run_reseq(control, force=True)
    out = (res, control.state_crc(), control.ecv()["ecv_down"])
    control.close()
    return base, out, dir_bytes(sd)


@pytest.mark.parametrize("site", SITES)
def test_kill_at_every_reseq_boundary_resumes_as_the_reference(
        tmp_path, monkeypatch, site):
    """Killed at each phase boundary (and mid-fold at an ext block),
    reopened from disk and resumed: the generation equals the
    uninterrupted rebuild (state_crc, ECV(down)), the manifest chain
    closes, fsck passes, and every byte equals the reference's."""
    monkeypatch.setenv("SHEEP_EXT_BLOCK", "128")
    ins = skewed_inserts(20)

    def run(side):
        base, control, control_files = _control(side, tmp_path, ins)
        reseq = mod(side, "serve.reseq")
        faults = mod(side, "serve.faults")
        rt = mod(side, "runtime")
        sd = str(tmp_path / "work" / f"kill-{site}")
        shutil.copytree(base, sd)
        victim = mod(side, "serve").ServeCore.open(sd)
        if site == "ext-boundary":
            rt.reset_counters()
            rt.install_plan(rt.FaultPlan(site="ext-boundary", at=1,
                                         kind="kill"))
            kill = rt.BuildKilled
        else:
            faults.install_plan(faults.parse_serve_fault_plan(
                f"kill@{site}:0", kill_mode="raise"))
            kill = faults.ServeKilled
        with pytest.raises(kill):
            reseq.run_reseq(victim, force=True)
        rt.clear_plan()
        rt.reset_counters()
        faults.clear_plan()
        victim.close()
        mid = (reseq.load_manifest(sd)["phase"], fsck(side, [sd], "repair"))
        revived = mod(side, "serve").ServeCore.open(sd)
        out = reseq.resume_reseq(revived)
        res = (out, revived.seq_gen, revived.state_crc(),
               revived.ecv()["ecv_down"], reseq.load_manifest(sd),
               os.path.exists(reseq.pending_path(sd)), fsck(side, [sd]))
        revived.close()
        return control, control_files, mid, res, dir_bytes(sd)
    control, _, _, res, _ = both(tmp_path, run)
    out, gen, crc, ecv, man, pending, (lines, failures) = res
    assert out is not None and not out.get("stale")
    assert gen == 1 and (crc, ecv) == control[1:]
    assert man["phase"] == "done" and not pending and failures == 0


@pytest.mark.parametrize("reopen", [False, True], ids=["live", "reopened"])
@pytest.mark.parametrize("site", ("reseq-fold", "reseq-swap"))
def test_inserts_after_the_cut_replay_into_the_swap_as_the_reference(
        tmp_path, site, reopen):
    """Stopped at a reseq site after the manifest pinned its cut, the
    store takes more inserts (new vids, self-loops, links into the old
    tree) and then resumes: the swap replays the post-cut inserts
    through the live link fold onto the new tree.  state_crc, ECV(down),
    stats and every state-dir byte equal the reference's."""
    ins = skewed_inserts(16)
    rng = np.random.default_rng(31)
    post = np.concatenate([
        rng.integers(0, 128, (40, 2)),
        [[7, 7], [300, 5], [301, 300], [12, 302]],
        skewed_inserts(12, seed=4)]).astype(np.uint32)

    def run(side):
        reseq = mod(side, "serve.reseq")
        faults = mod(side, "serve.faults")
        core, sd, _, _ = state(side, tmp_path)
        for row in ins:
            core.insert(row.reshape(1, 2))
        faults.install_plan(faults.parse_serve_fault_plan(
            f"kill@{site}:0", kill_mode="raise"))
        with pytest.raises(faults.ServeKilled):
            reseq.run_reseq(core, force=True)
        faults.clear_plan()
        cut = reseq.load_manifest(sd)["cut"]
        if reopen:
            core.close()
            core = mod(side, "serve").ServeCore.open(sd)
        for k in range(0, len(post), 8):
            core.insert(post[k:k + 8])
        out = reseq.resume_reseq(core)
        res = (cut, out, core.seq_gen, core.state_crc(), core.stats(),
               core.ecv(), core.seq_drift, core.drift_cut,
               reseq.load_manifest(sd)["phase"], fsck(side, [sd]))
        core.close()
        again = mod(side, "serve").ServeCore.open(sd)
        res += (again.state_crc(),)
        again.close()
        return res, dir_bytes(sd)
    (cut, out, gen, crc, *_, phase, (_, failures), crc2), _ = both(
        tmp_path, run)
    assert cut == len(ins) and out["replayed"] == len(post)
    assert gen == 1 and phase == "done" and failures == 0 and crc2 == crc


def test_kill_after_seal_finalizes_as_the_reference(tmp_path):
    def run(side):
        reseq = mod(side, "serve.reseq")
        core, sd, _, _ = state(side, tmp_path)
        for row in skewed_inserts(12):
            core.insert(row.reshape(1, 2))
        first = reseq.run_reseq(core, force=True)
        man = reseq.load_manifest(sd)
        man["phase"] = "swap"
        man["chain"] = man["chain"][:1]
        reseq.save_manifest(sd, man)
        core.close()
        revived = mod(side, "serve").ServeCore.open(sd)
        out = (first, revived.seq_gen, reseq.resume_reseq(revived),
               reseq.load_manifest(sd)["phase"], fsck(side, [sd]))
        revived.close()
        return out, dir_bytes(sd)
    got = both(tmp_path, run)
    assert got[0][2] == {"resumed": "finalize", "seq_gen": 1}
    assert got[0][4][1] == 0


def test_fsck_reseq_chain_equals_reference(tmp_path):
    """The chain of a re-sequenced dir passes; an unsanctioned
    generation fails; a torn mid-swap log (old-generation records past
    the re-sequenced snapshot) is refused strict and reported truncatable
    in repair — line for line the reference's, through the library and
    the tool."""
    def run(side):
        reseq = mod(side, "serve.reseq")
        wal = mod(side, "serve.wal")
        enc = mod(side, "serve.state").encode_inserts
        core, sd, _, _ = state(side, tmp_path)
        old_sig = core.sig
        for row in skewed_inserts(10):
            core.insert(row.reshape(1, 2))
        reseq.run_reseq(core, force=True)
        applied = core.applied_seqno
        core.close()
        steps = [fsck(side, [sd])]
        man = reseq.load_manifest(sd)
        saved = man["chain"]
        man["chain"] = [c for c in saved if c["gen"] == 0]
        man["phase"] = "hist"
        reseq.save_manifest(sd, man)
        steps.append(fsck(side, [sd]))
        man["chain"], man["phase"] = saved, "done"
        reseq.save_manifest(sd, man)
        w = wal.wal_path(sd)
        os.unlink(w)
        wal.create_wal(w, old_sig)
        with wal.WalAppender(w) as app:
            app.append_at(applied + 1, enc(np.array([[1, 2]], np.uint32)))
        for mode in ("strict", "repair"):
            steps.append(fsck(side, [sd], mode))
            steps.append(fsck(side, [w], mode))
        return steps, dir_bytes(sd)
    steps = both(tmp_path, run)[0]
    assert steps[0][1] == 0
    assert steps[1][1] and any("never sanctioned" in r[2]
                               for r in steps[1][0] if not r[1])
    assert steps[3][1] == 1
    assert "torn mid-re-sequence swap" in steps[3][0][0][2]
    assert "torn_records=1" in steps[5][0][0][2]


@pytest.mark.parametrize("case", ["clean", "wal", "snap", "manifest"])
def test_fsck_cli_on_a_reseq_dir_equals_reference(tmp_path, case, capsys):
    def run(side):
        core, sd, _, _ = state(side, tmp_path)
        for row in skewed_inserts(10):
            core.insert(row.reshape(1, 2))
        mod(side, "serve.reseq").run_reseq(core, force=True)
        core.insert(np.array([[3, 4]], np.uint32))
        core.close()
        target = {"wal": "serve.wal", "snap": "snap-000000000010.snap",
                  "manifest": "reseq.json"}.get(case)
        if target:
            p = os.path.join(sd, target)
            data = bytearray(open(p, "rb").read())
            data[len(data) // 2] ^= 0x5A
            open(p, "wb").write(bytes(data))
        outs = []
        for argv in ([sd], ["-q", sd], ["-m", "repair", sd]):
            capsys.readouterr()
            rc = mod(side, "cli.fsck").main(argv)
            outs.append((rc, capsys.readouterr().out))
        return outs
    outs = both(tmp_path, run)
    assert (outs[0][0] == 0) == (case == "clean")


def test_plan_reseq_learns_fold_throughput_as_the_reference(tmp_path,
                                                            monkeypatch):
    import time

    records, inserted = 1 << 20, 1 << 10
    blob = (records + inserted) * 12

    def run(side):
        model = mod(side, "plan.model")
        priors = mod(side, "plan.priors")
        obs = mod(side, "obs.trace")
        out = [model.plan_reseq(records, inserted, 5, horizon_s=60.0)]
        tpath = str(tmp_path / "work" / "r.trace")
        monkeypatch.setenv("SHEEP_TRACE", tpath)
        try:
            for _ in range(2):
                with obs.span("reseq.fold", bytes=blob, records=records):
                    time.sleep(0.01)
        finally:
            obs.close_recorder()
            monkeypatch.delenv("SHEEP_TRACE")
        st = priors.PriorStore()
        harvested = st.harvest_trace(tpath)
        p = priors.fold_bps(st, blob)
        out.append((harvested, p["count"], p["mean"] > 0))
        stores = {}
        for name, scale, k in (("slow", blob, 2), ("thin", blob, 1),
                               ("far", blob // 1024, 2)):
            s = priors.PriorStore()
            for _ in range(k):
                s.observe("fold_bps", "reseq", scale, float(4 << 20))
            stores[name] = s
        for name, horizon in (("slow", 60.0), ("slow", 1.0),
                              ("thin", 60.0), ("far", 60.0)):
            out.append(model.plan_reseq(records, inserted, 5,
                                        horizon_s=horizon,
                                        priors=stores[name]))
        out.append(priors.fold_bps(None, blob))
        for pin in ("go", "stay", "bogus"):
            monkeypatch.setenv("SHEEP_RESEQ_PIN", pin)
            try:
                out.append(model.plan_reseq(records, inserted, 0))
            except ValueError as exc:
                out.append(str(exc))
        monkeypatch.delenv("SHEEP_RESEQ_PIN")
        out.append(model.plan_reseq(records, inserted, 0))
        return out
    out = both(tmp_path, run)
    base, learned = out[0], out[2]
    assert base["decision"] == "go" and base["provenance"] == "priced"
    assert base["fold_bps"] == mod("port", "plan").RESEQ_FOLD_BPS
    assert out[1] == (2, 2, True)
    assert learned["provenance"] == "learned"
    assert learned["fold_bps"] == 4 << 20
    assert learned["analytic_cost_s"] == base["cost_s"]
    assert out[3]["decision"] == "stay"
    assert out[4]["provenance"] == out[5]["provenance"] == "priced"
