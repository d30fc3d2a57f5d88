"""The port's distributed out-of-core build (sheep_tpu_torch.ops.distext,
``cli.distext`` and ``graph2tree --distext``) against the reference's, on
the same seeded ``.dat`` files.

The twins of tests/test_distext.py: the ``end_edge`` range reader, the
shard plan and the histogram Allreduce, the sealed ``.hist`` artifact
and its fsck checks, the per-leg range builds and their checkpoint
identity, the supervised job end to end (the oracle's tree, exact
dispatch counts), the chaos sweep at every round, a supervisor killed
and resumed, the EIO/ENOSPC faults, a map leg killed mid-range, fsck of
the state dir and its shard-map chain, the leg planner, the routing,
the CLI, ``--status`` progress and the legs' self-reports.  Each runs
both packages, each in a directory of its own with the same relative
state dir, and compares the final tree, the manifest JSON, the ``.hist``
bytes, the sidecars, dispatch counts, events and exceptions exactly.
Legs run in process (``InlineRunner``); one job runs through the
production runner, whose legs must be the port's ``python -m
sheep_tpu_torch.cli.distext`` and never load torch.  Also here: the
metrics registry (``obs.metrics``), the trace rollup, the transport
planner and the ship transport, which waits for the serving tier.
"""

import contextlib
import importlib
import io
import json
import os
import re
import threading

import numpy as np
import pytest

from sheep_tpu.core import build_forest, degree_sequence
from sheep_tpu.io.edges import write_dat
from sheep_tpu.utils.synth import rmat_edges

from test_torch_supervisor import MARK, join_new_threads, watch_legs

PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def clear_faults():
    for side in PKGS:
        mod(side, "io.faultfs").clear_plan()
        rt = mod(side, "runtime")
        rt.clear_plan()
        rt.reset_counters()


@pytest.fixture
def dist_env(monkeypatch):
    for k in ("SHEEP_EXT_BLOCK", "SHEEP_EXT_STRATEGY", "SHEEP_MEM_BUDGET",
              "SHEEP_DISK_BUDGET", "SHEEP_IO_FAULT_PLAN",
              "SHEEP_FAULT_INJECT", "SHEEP_FAULT_PLAN",
              "SHEEP_DISTEXT_LEGS", "SHEEP_LEG_CORES", "SHEEP_WORKERS",
              "SHEEP_WORKER_ADDRS", "SHEEP_WORKER_TRANSPORT"):
        monkeypatch.delenv(k, raising=False)
    clear_faults()
    yield monkeypatch
    clear_faults()


def graph_file(d, log_n=9, seed=41):
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=seed)
    path = str(d / "g.dat")
    write_dat(path, tail, head)
    seq = degree_sequence(tail, head)
    return path, tail, head, seq, build_forest(tail, head, seq)


def both(tmp_path, monkeypatch, fn):
    """``fn(side)`` in ``tmp_path/<side>`` for each package; returns
    (reference's result, port's result).  Threads a killed supervisor
    abandoned are joined before the working directory moves."""
    out = {}
    for side in PKGS:
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        before = set(threading.enumerate())
        try:
            out[side] = fn(side)
        finally:
            clear_faults()
        join_new_threads(before)
    monkeypatch.chdir(tmp_path)
    return out["ref"], out["port"]


def config(side: str, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("poll_s", 0.01)
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("grammar", False)
    return mod(side, "supervisor").SupervisorConfig(**kw)


#: files of a state dir whose bytes hold clock readings or a pid
_VOLATILE = (".perf.json", ".hb")


def state_files(state_dir: str) -> dict:
    out = {}
    for root, _, names in os.walk(state_dir):
        for name in names:
            p = os.path.join(root, name)
            out[os.path.relpath(p, state_dir)] = (
                None if name.endswith(_VOLATILE) else open(p, "rb").read())
    return out


def distext(side: str, graph: str, state_dir: str = "st", legs: int = 2,
            runner=None, files: bool = True, **kw) -> dict:
    """One distext job in the cwd, as comparable data; a failure is
    recorded by type and message."""
    sup = mod(side, "supervisor")
    cfg = config(side, **kw)
    rec: dict = {}
    try:
        m = mod(side, "ops.distext").run_distext(
            graph, state_dir, cfg, runner=runner or sup.InlineRunner(0.05),
            legs=legs)
        rec["tree"] = open(m.final_tree, "rb").read()
        rec["dispatches"] = {leg.key: leg.dispatches for leg in m.legs}
    except (sup.SupervisionFailed, sup.SupervisorKilled) as exc:
        rec["raised"] = (type(exc).__name__, str(exc))
    rec["events"] = sorted(map(repr, cfg.events))
    if files:
        rec["files"] = state_files(state_dir)
    return rec


# ---------------------------------------------------------------------------
# the range reader, the shard plan, the Allreduce
# ---------------------------------------------------------------------------


def test_end_edge_ranges_equal_reference(tmp_path, dist_env):
    """[start_edge, end_edge) slices, empty and overlong ranges, a resume
    offset and a partial load under a range: the port's reader yields
    the reference's blocks."""
    path, tail, *_ = graph_file(tmp_path)
    E = len(tail)
    cases = [(100, {"start_edge": a, "end_edge": b}) for a, b in (
        (0, E), (0, 1), (1, 2), (100, 612), (E - 1, E), (0, E // 2),
        (E // 2, E), (7, 340), (5, 5), (10, 3), (E, E), (E, E + 50),
        (E - 3, E + 99))]
    cases += [(128, {"start_edge": 300 + k * 128, "end_edge": 1700})
              for k in (0, 1, 3, 7)]
    cases += [(50, {"part": 2, "num_parts": 3, "start_edge": 10,
                    "end_edge": 200})]
    for block, kw in cases:
        got = [[(t.tolist(), h.tolist()) for t, h in
                mod(side, "io.edges").iter_dat_blocks(path, block, **kw)]
               for side in PKGS]
        assert got[1] == got[0], kw


def test_plan_shards_and_merge_equal_reference(tmp_path, dist_env):
    """The shard cover and the summed per-range histograms: the port's
    Allreduce gives the reference's whole-file histogram and sequence."""
    path, tail, head, seq0, _ = graph_file(tmp_path, seed=43)
    for records in (0, 1, 7, 1000, 2048):
        for legs in (1, 2, 3, 7):
            assert mod("port", "ops.distext").plan_shards(records, legs) \
                == mod("ref", "ops.distext").plan_shards(records, legs)
    for side in PKGS:
        with pytest.raises(ValueError):
            mod(side, "ops.distext").plan_shards(100, 0)
    for legs in (2, 3, 5):
        got = []
        for side in PKGS:
            dx = mod(side, "ops.distext")
            ext = mod(side, "ops.extmem")
            hists = []
            for a, b in dx.plan_shards(len(tail), legs):
                deg, mv, rec = ext.range_degree_histogram(
                    path, 300, start_edge=a, end_edge=b)
                hists.append({"deg": deg[: mv + 1 if rec else 0],
                              "records": rec, "max_vid": mv,
                              "start": a, "end": b})
            summed = dx.merge_histograms(hists)
            seq = mod(side, "core.sequence").degree_sequence_from_degrees(
                summed)
            got.append((summed.tolist(), seq.tolist()))
        assert got[1] == got[0]
        np.testing.assert_array_equal(got[1][1], seq0)


def test_hist_artifact_and_fsck_equal_reference(tmp_path, dist_env):
    """``write_histogram`` seals the reference's bytes and sidecar;
    ``read_histogram`` and fsck read them back, and refuse a flipped
    byte (strict, then on the structural checks in trust) with the
    reference's exception types."""
    path, *_ = graph_file(tmp_path)
    got = {}
    for side in PKGS:
        dx = mod(side, "ops.distext")
        fsck = mod(side, "integrity.fsck")
        deg, mv, rec = mod(side, "ops.extmem").range_degree_histogram(
            path, 500, start_edge=100, end_edge=900)
        hp = str(tmp_path / f"{side}.hist")
        dx.write_histogram(hp, deg, rec, mv, 100, 900)
        h = dx.read_histogram(hp)
        out = [open(hp, "rb").read(), open(hp + ".sum", "rb").read(),
               (h["records"], h["start"], h["end"], h["max_vid"],
                h["deg"].tolist()), fsck.fsck_file(hp)]
        with open(hp, "r+b") as f:
            f.seek(40)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        for mode in (None, "trust"):
            try:
                dx.read_histogram(hp, integrity=mode)
                out.append(None)
            except Exception as exc:  # the type is what is compared
                out.append(type(exc).__name__)
        got[side] = out
    assert got["port"] == got["ref"]
    assert "range=[100:900)" in got["port"][3]
    assert got["port"][4:] == ["ChecksumMismatch", "MalformedArtifact"]


def test_hist_merge_refusals_equal_reference(tmp_path, dist_env):
    path, *_ = graph_file(tmp_path)
    for expect in ([[0, 999]], [[0, 1000], [1000, 2000]]):
        msgs = []
        for side in PKGS:
            deg, mv, rec = mod(side, "ops.extmem").range_degree_histogram(
                path, 500, end_edge=1000)
            h = {"deg": deg[: mv + 1], "records": rec, "max_vid": mv,
                 "start": 0, "end": 1000}
            errors = mod(side, "integrity.errors")
            with pytest.raises(errors.MalformedArtifact) as exc:
                mod(side, "ops.distext").merge_histograms(
                    [h] * (3 - len(expect)), expect_shards=expect)
            msgs.append(str(exc.value))
        assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# the supervised job end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("legs", [1, 2, 3])
def test_distext_job_equals_reference(tmp_path, monkeypatch, dist_env,
                                      legs):
    """Every file of the state dir (manifest and sidecar, ``.hist``
    histograms, the shared sequence, the partial trees, the final tree)
    equals the reference's byte for byte, each leg dispatched once, and
    the tree is the oracle's."""
    path, tail, head, seq0, want = graph_file(tmp_path)
    ref, port = both(tmp_path, monkeypatch,
                     lambda side: distext(side, path, legs=legs))
    assert port == ref
    assert set(port["dispatches"].values()) == {1}
    from sheep_tpu_torch.io.seqfile import read_sequence
    from sheep_tpu_torch.io.trefile import read_tree
    st = str(tmp_path / "port" / "st")
    parent, pst = read_tree(os.path.join(st, "g.tre"))
    np.testing.assert_array_equal(parent, want.parent)
    np.testing.assert_array_equal(pst, want.pst_weight)
    np.testing.assert_array_equal(read_sequence(os.path.join(st, "g.seq")),
                                  seq0)


def test_rerun_and_refusals_equal_reference(tmp_path, monkeypatch,
                                            dist_env):
    """A rerun re-dispatches nothing; a different leg count over the
    same state dir, a ``.net`` input and a plain tournament's state dir
    are refused with the reference's messages."""
    path, tail, head, *_ = graph_file(tmp_path)
    from sheep_tpu.io.edges import write_net
    net = str(tmp_path / "g.net")
    write_net(net, tail, head)

    def run(side):
        first = distext(side, path)
        again = distext(side, path)
        foreign = distext(side, path, legs=3, files=False)
        text = distext(side, net, "st2", files=False)
        mod(side, "supervisor").run_supervised(
            path, "plain", config(side), runner=mod(
                side, "supervisor").InlineRunner(0.05))
        kinds = distext(side, path, "plain", files=False)
        return first, again, foreign, text, kinds

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    first, again, foreign, text, kinds = port
    assert again["tree"] == first["tree"]
    assert again["dispatches"] == first["dispatches"]
    assert "shard map" in foreign["raised"][1]
    assert ".dat" in text["raised"][1]
    assert "job kinds" in kinds["raised"][1]


#: (round, leg) -> the key of that leg in a 2-leg job
KEYS = {(-2, 0): "h.00", (-2, 1): "h.01", (-1, 0): "sort",
        (0, 0): "r0.00", (0, 1): "r0.01", (1, 0): "r1.00"}


@pytest.mark.parametrize("kind", ["kill", "corrupt", "hang"])
def test_chaos_at_every_round_equals_reference(tmp_path, monkeypatch,
                                               dist_env, kind):
    """kill/corrupt/hang at every (round, leg) of the bracket — the hist
    legs, the histogram merge, the map legs, the merge — each gives the
    fault-free tree and re-dispatches ONLY the faulted leg, as in the
    reference."""
    path, *_ = graph_file(tmp_path)

    def sweep(side):
        parse = mod(side, "supervisor").parse_fault_plan
        out = {"base": distext(side, path, "base", files=False)}
        for rnd, leg in KEYS:
            out[(rnd, leg)] = distext(
                side, path, f"{kind}{rnd}x{leg}", files=False,
                chaos=parse(f"{kind}@{rnd}:{leg}"),
                stale_after_polls=25 if kind == "hang" else 0)
        return out

    ref, port = both(tmp_path, monkeypatch, sweep)
    for at, key in KEYS.items():
        assert port[at]["tree"] == port["base"]["tree"], at
        counts = port[at]["dispatches"]
        assert counts[key] == 2
        assert all(n == 1 for k, n in counts.items() if k != key), counts
    assert port == ref


def test_supervisor_death_equals_reference(tmp_path, monkeypatch,
                                           dist_env):
    """stop after a hist leg and after a map leg: the resumed job keeps
    every published leg and ends in the fault-free tree and files.  One
    attempt at a time, so what had published when the supervisor died
    does not depend on the scheduler."""
    path, *_ = graph_file(tmp_path)

    def run(side):
        parse = mod(side, "supervisor").parse_fault_plan
        out = {"base": distext(side, path, "base", files=False)}
        for rnd, leg in ((-2, 0), (0, 0)):
            sd = f"stop{rnd}x{leg}"
            died = distext(side, path, sd, files=False, cores=1,
                           chaos=parse(f"stop@{rnd}:{leg}"))
            out[(rnd, leg)] = (died, distext(side, path, sd, files=False,
                                             cores=1))
        return out

    ref, port = both(tmp_path, monkeypatch, run)
    for at, done in (((-2, 0), {"h.00"}),
                     ((0, 0), {"h.00", "h.01", "sort", "r0.00"})):
        died, again = port[at]
        assert died["raised"][0] == "SupervisorKilled"
        assert again["tree"] == port["base"]["tree"]
        assert all(again["dispatches"][k] == 1 for k in done)
    assert port == ref


@pytest.mark.parametrize("fault", ["eio@dat:1", "enospc@hist:0",
                                   "leg_kill"])
def test_io_faults_and_leg_kill_equal_reference(tmp_path, monkeypatch,
                                                dist_env, fault):
    """An EIO at a block read retries inside the leg (no re-dispatch);
    an ENOSPC at the histogram publish fails that attempt and the
    re-dispatch publishes; a map leg killed at a block boundary is
    re-dispatched and resumes from its own checkpoint.  Each gives the
    reference's counts and the fault-free tree."""
    path, *_ = graph_file(tmp_path)

    def run(side):
        base = distext(side, path, "base", files=False)
        if fault == "leg_kill":
            monkeypatch.setenv("SHEEP_EXT_BLOCK", "200")
            rt = mod(side, "runtime")
            rt.reset_counters()
            rt.install_plan(rt.FaultPlan(site="ext-boundary", at=1,
                                         kind="kill"))
        else:
            monkeypatch.setenv("SHEEP_EXT_BLOCK", "300")
            ff = mod(side, "io.faultfs")
            ff.install_plan(ff.parse_io_fault_plan(fault))
        hurt = distext(side, path, "hurt", cores=1, files=False)
        monkeypatch.delenv("SHEEP_EXT_BLOCK")
        return base, hurt

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    base, hurt = port
    assert hurt["tree"] == base["tree"]
    again = {"eio@dat:1": None, "enospc@hist:0": "h.00",
             "leg_kill": "r0.00"}[fault]
    assert {k: n for k, n in hurt["dispatches"].items() if n != 1} == \
        ({again: 2} if again else {})


# ---------------------------------------------------------------------------
# fsck: the state dir and the shard-map chain
# ---------------------------------------------------------------------------


def _fsck(side: str, argv: list):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod(side, "cli.fsck").main(argv)
    return rc, buf.getvalue()


def test_fsck_state_dir_equals_reference(tmp_path, monkeypatch, dist_env):
    """fsck of a distext state dir: the same lines for every ``.hist``
    and the manifest chain; a histogram rebuilt over the wrong range, a
    hole in the shard map and a plain tournament's dir as the
    reference reports them."""
    path, *_ = graph_file(tmp_path)
    from sheep_tpu.io.edges import write_net
    tail, head = rmat_edges(6, 4 << 6, seed=5)
    net = str(tmp_path / "p.net")
    write_net(net, tail, head)

    def run(side):
        dx = mod(side, "ops.distext")
        man = mod(side, "supervisor.manifest")
        fsck = mod(side, "integrity.fsck")
        distext(side, path, files=False)
        out = [_fsck(side, ["st"]), _fsck(side, ["-q", "st"]),
               _fsck(side, ["st/g00.hist", "st/manifest.json"]),
               fsck.fsck_distext_manifest("st")]
        deg, mv, rec = mod(side, "ops.extmem").range_degree_histogram(
            path, 500, start_edge=0, end_edge=500)
        dx.write_histogram("st/g00.hist", deg, rec, mv, 0, 500)
        out.append(_fsck(side, ["st"]))
        m = man.load_manifest("st")
        m.shards[1][0] += 1
        man.save_manifest(m, "st")
        out.append(_fsck(side, ["st"]))
        try:
            fsck.fsck_distext_manifest("st")
        except Exception as exc:  # the type and message are compared
            out.append((type(exc).__name__, str(exc)))
        mod(side, "supervisor").run_supervised(
            net, "plain", config(side), runner=mod(
                side, "supervisor").InlineRunner(0.05))
        out += [_fsck(side, ["plain"]), fsck.fsck_distext_manifest("plain")]
        return out

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    assert port[0][0] == 0 and "shard-map-ok" in port[0][1]
    assert port[4][0] == 1 and port[5][0] == 1
    assert port[6][0] == "MalformedArtifact" and "contiguous" in port[6][1]
    assert port[7][0] == 0 and port[8] is None


# ---------------------------------------------------------------------------
# planning, routing, the CLI, status, the legs' self-reports
# ---------------------------------------------------------------------------


def test_leg_and_transport_plans_equal_reference(dist_env, monkeypatch):
    """``plan_distext_legs`` and ``plan_transport`` decide as the
    reference's do: forced, priced and default leg counts, and the
    transport with no fleet, a pin, a priced fleet and a bad pin."""
    for side in PKGS:
        monkeypatch.setattr(mod(side, "resources.governor"), "rss_bytes",
                            lambda: 0)

    def plans(side):
        G = mod(side, "resources.governor")
        plan = mod(side, "plan")
        out = [plan.plan_distext_legs(),
               plan.plan_distext_legs(governor=G.ResourceGovernor(
                   mem_budget=1 << 20)),
               plan.plan_distext_legs(n=1 << 20, governor=G.ResourceGovernor(
                   mem_budget=64 << 20))]
        for args, kw in (((1 << 20, 4, 0), {}),
                         ((1 << 20, 4, 2), {"pin": "ship"}),
                         ((1 << 20, 4, 2), {"pin": "local"}),
                         ((1 << 26, 16, 8), {"host_cores": 2}),
                         ((1 << 26, 16, 1), {"host_cores": 8}),
                         ((0, 0, 3), {"host_cores": 1})):
            out.append(plan.plan_transport(*args, **kw))
        try:
            plan.plan_transport(10, 2, 1, pin="wire")
        except ValueError as exc:
            out.append(str(exc))
        model = mod(side, "plan.model")
        return out + [model.TRANSPORT_DISK_BPS, model.TRANSPORT_WIRE_BPS,
                      plan.WORKER_TRANSPORT_ENV]

    assert plans("port") == plans("ref")
    monkeypatch.setenv("SHEEP_DISTEXT_LEGS", "5")
    assert plans("port") == plans("ref")
    assert plans("port")[0]["provenance"] == "forced"


def test_should_use_distext_equals_reference(tmp_path, dist_env,
                                             monkeypatch):
    path, *_ = graph_file(tmp_path)
    for side in PKGS:
        monkeypatch.setattr(mod(side, "resources.governor"), "rss_bytes",
                            lambda: 0)

    def routes(side):
        dx = mod(side, "ops.distext")
        G = mod(side, "resources.governor")
        return [dx.should_use_distext(path),
                dx.should_use_distext(str(tmp_path / "g.net")),
                dx.should_use_distext(path,
                                      G.ResourceGovernor(mem_budget=1 << 18)),
                dx.should_use_distext(path,
                                      G.ResourceGovernor(mem_budget=1 << 24))]

    assert routes("port") == routes("ref") == [False, False, True, False]
    monkeypatch.setenv("SHEEP_DISTEXT_LEGS", "2")
    assert routes("port") == routes("ref") == [True, False, True, True]
    monkeypatch.setenv("SHEEP_DISTEXT_LEGS", "1")
    assert routes("port") == routes("ref")


def test_graph2tree_distext_in_process_equals_reference(
        tmp_path, monkeypatch, dist_env):
    """``graph2tree --distext`` (the legs as processes) and its fallback
    for a partition request: the same exit codes, stdout, warnings and
    files as the reference, the tree the oracle's."""
    path, tail, head, _, want = graph_file(tmp_path, seed=53)
    monkeypatch.setenv("SHEEP_DISTEXT_LEGS", "2")

    def run(side):
        g2t = mod(side, "cli.graph2tree")
        kw = {"device": "cpu"} if side == "port" else {}
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rcs = [g2t.main([path, "-o", "out.tre", "--distext"], **kw),
                   g2t.main([path, "-o", "p", "-p", "4", "--distext"],
                            **kw)]
        return (rcs, re.sub(r"[0-9.]+ seconds", "T", out.getvalue()),
                err.getvalue(), state_files("."))

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    assert port[0] == [0, 0]
    assert "falling back to the single-process path" in port[2]
    from sheep_tpu_torch.io.trefile import read_tree
    parent, pst = read_tree(str(tmp_path / "port" / "out.tre"))
    np.testing.assert_array_equal(parent, want.parent)
    np.testing.assert_array_equal(pst, want.pst_weight)


def test_status_reports_leg_progress_equal_reference(tmp_path, monkeypatch,
                                                     dist_env):
    """A map leg killed mid-range with no retry left: the job fails as
    the reference's does, and ``--status`` reports the leg's blocks done
    and total from its own checkpoint as the reference does."""
    path, *_ = graph_file(tmp_path)
    monkeypatch.setenv("SHEEP_EXT_BLOCK", "200")

    def run(side):
        rt = mod(side, "runtime")
        rt.reset_counters()
        rt.install_plan(rt.FaultPlan(site="ext-boundary", at=1,
                                     kind="kill"))
        rec = distext(side, path, cores=1, max_retries=0, files=False)
        rt.clear_plan()
        status = mod(side, "supervisor.status")
        sj = status.status_json("st")
        rows = [{k: v for k, v in r.items() if k != "heartbeat_age_s"}
                for r in sj["legs"]]
        text = [ln for ln in status.render_status("st").splitlines()
                if not ln.startswith(("disk:", "mem:"))]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod(side, "cli.supervise").main(["--status", "-d", "st"])
        return rec, rows, text, rc

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    row = next(r for r in port[1] if r["key"] == "r0.00")
    assert (row["ext_blocks_done"], row["ext_blocks_total"]) == \
        (2, -(-1024 // 200))
    assert any("2/6blk" in ln for ln in port[2]) and port[3] == 0


def test_leg_self_reports_match_the_reference_shape(tmp_path, monkeypatch,
                                                    dist_env):
    """Each map leg's ``--perf-out`` record has the reference's keys:
    the ext perf dict, the range, the verb and ``proc_status`` (VmHWM
    as /proc gives it)."""
    path, *_ = graph_file(tmp_path)

    def run(side):
        distext(side, path, files=False)
        dx = mod(side, "ops.distext")
        out = {}
        for key in ("r0.00", "r0.01"):
            with open(dx.leg_perf_path("st", key)) as f:
                rep = json.load(f)
            out[key] = (sorted(rep), rep["verb"], rep["range"],
                        sorted(rep["perf"]), sorted(rep["proc_status"]))
            assert 0.0 <= rep["perf"]["overlap_frac"] <= 1.0
        return out

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref


def test_leg_paths_live_bases_and_overlap_honesty_equal_reference(tmp_path):
    """The per-leg checkpoint and perf paths, the live temp names a
    sweep must spare (the perf report's included), and the overlap
    honesty rule give the reference's answers."""
    def answers(side):
        dx = mod(side, "ops.distext")
        gc = mod(side, "resources.gc")
        Leg = mod(side, "supervisor.manifest").Leg
        sup_mod = mod(side, "supervisor.supervise")
        leg = Leg(key="r0.00", kind="distmap", round=0, index=0, inputs=[],
                  output=str(tmp_path / "g.r0.00.tre"))
        att = sup_mod._Attempt(leg=leg, number=1, tmp=leg.output + ".a1",
                               hb=leg.output + ".a1.hb", handle=None,
                               started=0.0)
        sup = sup_mod.TournamentSupervisor.__new__(
            sup_mod.TournamentSupervisor)
        sup._running = {"r0.00": [att]}
        bases = sup._live_temp_bases()
        out = [dx.leg_checkpoint_dir("s", "r1.00"),
               dx.leg_perf_path("s", "h.01"), sorted(bases),
               [gc.is_live_temp(n, bases) for n in (
                   ".r0.00.perf.json.xyz123.tmp", ".g.r0.00.tre.a1.abc.tmp",
                   ".r0.01.perf.json.xyz.tmp")]]
        for rows, legs in (
                ({"a": {"affinity_cores": [0], "overlap_frac": 0.0},
                  "b": {"affinity_cores": [0], "overlap_frac": 0.12}}, 2),
                ({"a": {"affinity_cores": [0], "overlap_frac": 0.3},
                  "b": {"affinity_cores": [1], "overlap_frac": 0.4}}, 2),
                ({"a": {"overlap_frac": 0.0}}, 2), ({}, 3)):
            out.append((dx.apply_overlap_honesty(rows, legs), rows))
        return out

    assert answers("port") == answers("ref")
    assert answers("port")[3] == [True, True, False]


# ---------------------------------------------------------------------------
# the production runner, the ship transport, metrics and the rollup
# ---------------------------------------------------------------------------


def test_subprocess_legs_are_the_ports_and_load_no_torch(
        tmp_path, monkeypatch, dist_env):
    """Through the production runner every hist and map leg is ``python
    -m sheep_tpu_torch.cli.distext``, none loads torch, and the state dir
    equals an in-process run's."""
    path, *_ = graph_file(tmp_path)
    from sheep_tpu_torch.supervisor import SubprocessRunner
    for name in ("inline", "sub"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "inline")
    inline = distext("port", path)
    monkeypatch.chdir(tmp_path / "sub")
    started = watch_legs(monkeypatch)
    sub = distext("port", path, runner=SubprocessRunner(0.05))
    logs = {k: sub["files"].pop(k) for k in list(sub["files"])
            if k.startswith("logs")}
    assert sub == inline
    verbs = sorted((cmd[2], cmd[3]) for cmd in started)
    assert verbs == [("sheep_tpu_torch.cli.distext", "hist")] * 2 + \
        [("sheep_tpu_torch.cli.distext", "map")] * 2 + \
        [("sheep_tpu_torch.cli.merge_trees", "st/g00r0.tre")]
    assert len(logs) == 5
    for name, log in logs.items():
        assert re.findall(rf"^{MARK} (\w+)$", log.decode(), re.M) == \
            ["False"], name


def test_ship_transport_raises_naming_the_queue_item(tmp_path, monkeypatch,
                                                     dist_env):
    """Worker addresses with the transport pinned to ship: each
    package's job ships its hist and map legs to two worker daemons of
    its own package (no shared state dir) and the port's manifest,
    dispatch counts, tree and leg files equal the reference's; pinned
    local, no leg touches the wire and the tree is the same."""
    path, *_ = graph_file(tmp_path)
    monkeypatch.setenv("SHEEP_WORKER_TRANSPORT", "ship")

    def run(side):
        pair = [mod(side, "serve.worker").WorkerDaemon(f"w{i}").start()
                for i in (1, 2)]
        try:
            monkeypatch.setenv("SHEEP_WORKER_ADDRS", ",".join(
                f"{h}:{p}" for h, p in (w.address for w in pair)))
            cfg = mod(side, "supervisor").SupervisorConfig.from_env(
                poll_s=0.01, grammar=False)
            assert len(cfg.worker_addrs) == 2
            rec = distext(side, path, worker_addrs=cfg.worker_addrs,
                          worker_beat_s=0.05)
            wires = {k: rec["files"].pop(k) for k in list(rec["files"])
                     if k.startswith("wire-")}
            rec["wire"] = {k: (json.loads(v)["dispatches"],
                               json.loads(v)["speculations"])
                           for k, v in wires.items()}
            rec["shipped"] = [sorted(n for n in os.listdir(w.state_dir)
                                     if n.endswith(".slice.dat"))
                              for w in pair]
            return rec
        finally:
            for w in pair:
                w.shutdown()

    ref, port = both(tmp_path, monkeypatch, run)
    assert "raised" not in port, port.get("raised")
    assert port == ref
    assert set(port["dispatches"].values()) == {1}
    assert len(port["wire"]) == 4 and all(port["shipped"])
    monkeypatch.setenv("SHEEP_WORKER_TRANSPORT", "local")
    monkeypatch.chdir(tmp_path / "port")
    again = distext("port", path, state_dir="st2",
                    worker_addrs=[("127.0.0.1", 1)])
    assert again["tree"] == port["tree"]
    assert not [k for k in again["files"] if k.startswith("wire-")]


def test_metrics_registry_equals_reference(monkeypatch):
    """The registry renders the reference's scrape body, its quantiles
    and windows agree, and the scrape parser, the relabeller and the
    process gauges give the same answers."""
    def scrape(side):
        m = mod(side, "obs.metrics")
        clock = iter(float(t) for t in range(0, 400, 3))
        reg = m.Registry()
        reg.counter("reqs", "requests").labels(verb="GET").inc(3)
        reg.counter("reqs", "requests").labels(verb="PUT").inc()
        reg.counter("plain", "a plain counter").inc(2.5)
        reg.gauge("lag", "lag").set(7)
        h = m.Histogram("lat", "latency", clock=lambda: next(clock))
        for v in (0.00005, 0.003, 0.003, 0.2, 30.0):
            h.observe(v)
        reg._metrics["lat"] = h
        reg.histogram("lat2", "by verb").labels(verb="GET").observe(0.01)
        body = reg.render()
        return (body, [h.quantile(q) for q in (0.0, 0.5, 0.99, 1.0)],
                h.window_counts(), h.window_quantile(0.5),
                m.parse_prometheus(body + "junk\nx{a=\"1\"} 2\nbad line\n"),
                m.relabel(body, {"instance": "n1", "verb": "X"},
                          seen_headers=set()),
                m.relabel("", {"a": 1}), m._num(3.0), m._num(0.25))

    assert scrape("port") == scrape("ref")
    keys = {side: sorted(mod(side, "obs.metrics").proc_status())
            for side in PKGS}
    assert keys["port"] == keys["ref"]
    assert set(mod("port", "obs.metrics").proc_status(os.getpid())) >= \
        {"pid", "vmrss", "threads", "fds"}
    regs = []
    for side in PKGS:
        reg = mod(side, "obs.metrics").Registry()
        mod(side, "obs.metrics").set_process_gauges(reg, started_at=0.0)
        regs.append(sorted(reg._metrics))
    assert regs[1] == regs[0]


def test_trace_rollup_equals_reference():
    records = [
        {"k": "meta", "v": 1},
        {"k": "span", "name": "b", "dur": 0.25},
        {"k": "span", "name": "a", "dur": 1.5},
        {"k": "span", "name": "b", "dur": 0.125},
        {"k": "span"},
        {"k": "ev", "name": "x"}, {"k": "ev", "name": "x"}, {"k": "ev"},
    ]
    assert mod("port", "obs.trace").rollup(records) == \
        mod("ref", "obs.trace").rollup(records)
    assert mod("port", "obs.trace").rollup([]) == {}
