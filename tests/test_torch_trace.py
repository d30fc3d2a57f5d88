"""The port's flight recorder (sheep_tpu_torch.obs.trace with its request
ids and sampler, obs.merge) and the ``trace`` tool (cli.trace) against
the reference's.

The twins of tests/test_obs.py's span, torn-file, fsck and ``trace``
tests and of tests/test_fleetobs.py's rid grammar, ``rid_scope``,
rotation, segment-chain and merge tests.  Each scenario runs through
both packages (each has its own recorder), each into a file of its own,
and the records must be equal with the clock fields masked (``t``,
``dur``, the meta line's ``t0`` and ``pid``, the thread id, and a
measured ``rss_bytes``).  The readers, fsck and both ``trace`` tools
read the same files and must agree exactly: records, exceptions, stdout
and ``--json``."""

import contextlib
import importlib
import io
import json
import os
import threading
import warnings

import numpy as np
import pytest

from sheep_tpu.utils.synth import rmat_edges

PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
RID = "c0ffee01"


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def tr(side: str):
    return mod(side, "obs.trace")


@pytest.fixture(autouse=True)
def _clean_trace_env():
    saved = {k: os.environ.pop(k, None)
             for k in ("SHEEP_TRACE", "SHEEP_TRACE_MAX_MB",
                       "SHEEP_TRACE_SAMPLE")}
    for side in PKGS:
        tr(side).close_recorder()
        tr(side).sample_every()
    yield
    for side in PKGS:
        tr(side).close_recorder()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for side in PKGS:
        tr(side).sample_every()


MASKED = ("t", "dur", "t0", "pid", "tid")


def masked(records):
    out = []
    for r in records:
        r = {k: (None if k in MASKED else v) for k, v in r.items()}
        a = r.get("a")
        if isinstance(a, dict) and isinstance(a.get("rss_bytes"), int):
            r["a"] = dict(a, rss_bytes="<rss>")
        out.append(r)
    return out


def traced(tmp_path, fn, name="run.trace", env=None):
    """``fn(side, trace_module)`` under ``SHEEP_TRACE`` for each package;
    returns {side: (path, records read strictly)}."""
    got = {}
    for side in PKGS:
        t = tr(side)
        path = str(tmp_path / f"{side}-{name}")
        for k, v in (env or {}).items():
            os.environ[k] = v
        os.environ[t.ENV] = path
        t.sample_every()
        try:
            fn(side, t)
        finally:
            t.close_recorder()
            os.environ.pop(t.ENV, None)
            for k in env or {}:
                os.environ.pop(k, None)
            t.sample_every()
        got[side] = (path, t.read_trace_chain(path, "strict"))
    return got


def assert_same(got):
    assert masked(got["port"][1]) == masked(got["ref"][1])


def outcome(fn, *args):
    """A call's result, or its exception's type name and message."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return (type(exc).__name__, str(exc))


# -- span layer ---------------------------------------------------------------


def test_disabled_fast_path_is_noop_singleton():
    for side in PKGS:
        t = tr(side)
        assert not t.enabled()
        s1, s2 = t.span("a", x=1), t.span("b")
        assert s1 is s2 is t.NOOP_SPAN
        assert t.sampled_span("c") is t.NOOP_SPAN
        with s1:
            s1.annotate(y=2)
        t.event("nothing", z=3)
        t.annotate(w=4)
        assert t.trace_summary() is None
        assert t.current_rid() is None


def test_span_nesting_and_annotate_equal_reference(tmp_path):
    def run(side, t):
        with t.span("outer", a=1):
            with t.span("mid"):
                with t.span("leaf") as sp:
                    sp.annotate(k=7)
                    t.annotate(via_module=True)
            t.event("marker", hit=True)
    got = traced(tmp_path, run)
    assert_same(got)
    recs = got["port"][1]
    assert [r["name"] for r in recs if r["k"] == "span"] == \
        ["leaf", "mid", "outer"]
    leaf = [r for r in recs if r.get("name") == "leaf"][0]
    assert leaf["a"] == {"k": 7, "via_module": True}


def test_span_thread_safety(tmp_path):
    """Interleaved threads never cross-link their stacks; the spans and
    their attributes are the reference's as a multiset."""
    def run(side, t):
        def worker(i):
            for k in range(20):
                with t.span("outer", i=i, k=k):
                    with t.span("inner", i=i, k=k):
                        pass
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    got = traced(tmp_path, run)
    spans = [r for r in got["port"][1] if r["k"] == "span"]
    outers = {r["id"]: r for r in spans if r["name"] == "outer"}
    inners = [r for r in spans if r["name"] == "inner"]
    assert len(outers) == len(inners) == 120
    for r in inners:
        assert outers[r["par"]]["a"] == r["a"]
        assert outers[r["par"]]["tid"] == r["tid"]
    assert len({r["id"] for r in spans}) == len(spans)

    def bag(side):
        return sorted((r["name"], r["a"]["i"], r["a"]["k"])
                      for r in got[side][1] if r["k"] == "span")
    assert bag("port") == bag("ref")


def test_timed_and_overlap_stats_equal_reference():
    for side in PKGS:
        out = []
        with tr(side).timed("phase", out=out):
            pass
        assert len(out) == 1 and out[0] >= 0.0
    for args in ((2.0, 2.0), (2.0, 1.0), (0.0, 5.0), (1.0, 3.0),
                 (3.3, 1.7), (1e-9, 0.0)):
        assert tr("port").overlap_stats(*args) == \
            tr("ref").overlap_stats(*args)


def test_summary_counts_equal_reference(tmp_path):
    sums = {}

    def run(side, t):
        for k in range(3):
            with t.span("fold", block=k):
                pass
        t.event("fault", site="x")
        s = t.trace_summary()
        sums[side] = {name: ({"count": v["count"]} if "count" in v else v)
                      for name, v in s.items()}
    traced(tmp_path, run)
    assert sums["port"] == sums["ref"]
    assert sums["port"]["fold"]["count"] == 3
    assert sums["port"]["_events"] == {"fault": 1}


# -- the torn-tail contract ---------------------------------------------------


def ticks(name, count, **attrs):
    """``fn(side, t)`` recording ``count`` empty spans ``name``."""
    def run(side, t):
        for k in range(count):
            with t.span(name, k=k, **attrs):
                pass
    return run


def _sample_trace(tmp_path, spans=6):
    got = traced(tmp_path, ticks("phase", spans), name="kill.trace")
    assert_same(got)
    return got["port"][0]


def test_kill_at_every_byte_boundary_reads_as_the_reference(tmp_path):
    """Truncated at every byte: both readers agree in every mode (the
    salvaged prefix, the tear flag, or the typed refusal)."""
    path = _sample_trace(tmp_path)
    data = open(path, "rb").read()
    cut_path = str(tmp_path / "cut.trace")
    full = tr("port").read_trace(path, "strict")[0]
    for cut in range(len(data) + 1):
        with open(cut_path, "wb") as f:
            f.write(data[:cut])
        for mode in ("strict", "repair"):
            got = outcome(tr("port").read_trace, cut_path, mode)
            assert got == outcome(tr("ref").read_trace, cut_path, mode)
        recs, _, torn = outcome(tr("port").read_trace, cut_path,
                                "repair")[1]
        assert recs == full[:len(recs)]
        assert torn == (cut > 0 and not data[:cut].endswith(b"\n"))


def test_mid_file_rot_refused_as_the_reference(tmp_path):
    path = _sample_trace(tmp_path)
    lines = open(path, "rb").read().splitlines(keepends=True)
    lines[1] = b"\x00garbage\n"
    with open(path, "wb") as f:
        f.writelines(lines)
    for mode in ("strict", "repair", "trust"):
        got = outcome(tr("port").read_trace, path, mode)
        assert got[0] == "MalformedArtifact"
        assert got == outcome(tr("ref").read_trace, path, mode)


def test_repair_trace_equals_reference(tmp_path):
    path = _sample_trace(tmp_path)
    full = tr("port").read_trace(path, "strict")[0]
    twin = str(tmp_path / "twin.trace")
    data = open(path, "rb").read()
    for p in (path, twin):
        with open(p, "wb") as f:
            f.write(data + b'{"k":"span","name":"torn')
    assert outcome(tr("port").repair_trace, path) == ("ok", 24)
    assert outcome(tr("ref").repair_trace, twin) == ("ok", 24)
    assert open(path, "rb").read() == open(twin, "rb").read()
    assert tr("port").read_trace(path, "strict")[0] == full
    assert tr("port").repair_trace(path) == 0


def test_fsck_trace_rules_equal_reference(tmp_path):
    from sheep_tpu.integrity.fsck import fsck_file as ref_fsck
    from sheep_tpu_torch.integrity.fsck import fsck_file as port_fsck
    path = _sample_trace(tmp_path)
    steps = []
    steps.append([outcome(f, path, None) for f in (port_fsck, ref_fsck)])
    with open(path, "ab") as f:
        f.write(b'{"k":"ev"')
    for mode in ("strict", "repair"):
        steps.append([outcome(f, path, mode) for f in (port_fsck, ref_fsck)])
    os.unlink(path + ".sum")
    outcome(tr("port").repair_trace, path)
    steps.append([outcome(f, path, "strict") for f in (port_fsck, ref_fsck)])
    for got, want in steps:
        assert got == want
    assert "spans=6" in steps[0][0][1] and "sum=verified" in steps[0][0][1]
    assert "torn_tail=truncatable" in steps[2][0][1]
    assert "sum=absent" in steps[3][0][1]


def test_reopen_drops_the_seal_as_the_reference(tmp_path):
    def run(side, t):
        with t.span("first"):
            pass
        t.close_recorder()
        assert os.path.exists(os.environ[t.ENV] + ".sum")
        with t.span("more"):
            pass
        assert not os.path.exists(os.environ[t.ENV] + ".sum")
    got = traced(tmp_path, run)
    assert_same(got)
    for side in PKGS:
        assert os.path.exists(got[side][0] + ".sum")
    assert sum(r["k"] == "meta" for r in got["port"][1]) == 2


# -- request ids and the sampler ----------------------------------------------


def test_rid_scope_stamps_spans_and_events_as_the_reference(tmp_path):
    def run(side, t):
        with t.rid_scope(RID):
            with t.span("outer"):
                with t.span("inner"):
                    t.event("boom")
            assert t.current_rid() == RID
            with t.rid_scope("dd44"):
                t.event("nested")
            assert t.current_rid() == RID
        with t.rid_scope(None):
            with t.span("unscoped"):
                pass
        assert t.current_rid() is None
    got = traced(tmp_path, run)
    assert_same(got)
    by = {r.get("name"): r for r in got["port"][1] if r["k"] != "meta"}
    assert by["outer"]["rid"] == by["boom"]["rid"] == RID
    assert by["nested"]["rid"] == "dd44"
    assert "rid" not in by["unscoped"]


def test_new_rid_shape():
    t = tr("port")
    rids = {t.new_rid() for _ in range(100)}
    assert len(rids) == 100
    for rid in rids:
        assert len(rid) == 16 and int(rid, 16) >= 0


@pytest.mark.parametrize("spec", ["", "1/8", "16", "1", "2/8", "garbage",
                                  "0", "1/0", "-3"])
def test_sample_every_grammar_equals_reference(monkeypatch, spec):
    monkeypatch.setenv("SHEEP_TRACE_SAMPLE", spec)
    got = {}
    for side in PKGS:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got[side] = (tr(side).sample_every(),
                         [str(x.message) for x in w])
    assert got["port"] == got["ref"]


def test_sampled_span_records_one_in_n_as_the_reference(tmp_path):
    def run(side, t):
        for _ in range(10):
            with t.sampled_span("serve.req") as sp:
                sp.annotate(ok=True)
        with t.rid_scope("bb22"):
            with t.sampled_span("serve.req"):  # sampled out
                with t.span("wal.fsync"):      # still carries the rid
                    pass
    got = traced(tmp_path, run, env={"SHEEP_TRACE_SAMPLE": "1/4"})
    assert_same(got)
    spans = [r for r in got["port"][1] if r["k"] == "span"]
    reqs = [r for r in spans if r["name"] == "serve.req"]
    assert len(reqs) == 3 and all(r["a"]["sample"] == 4 for r in reqs)
    assert [r["rid"] for r in spans if r["name"] == "wal.fsync"] == ["bb22"]


LINES = ["RID=ab12cd34 PART 1 2", "DEADLINE=2 RID=ff01 INSERT 1 2",
         "RID=ff01 DEADLINE=2 INSERT 1 2", "PART 7",
         "XFUTURE=whatever RID=ab PART 3", "SPANCTX=a-b-c PING",
         "RID= PART 1", "RID=zz!! PART 1", "RID=" + "a" * 65 + " PART 1",
         "RID=ab12", "X2=1 PART 1", "DEADLINE=0.5 PART 1 2 3", "insert 1 2",
         "", "DEADLINE=x PART 1", "DEADLINE=1", "NOPE 1",
         "DEADLINE=-1 PING", "SUBTREE 4 5", "STATS", "ECV"]


@pytest.mark.parametrize("line", LINES)
def test_rid_prefix_grammar_equals_reference(line):
    def parse(side):
        def call():
            r = mod(side, "serve.protocol").parse_request(line)
            return (r.verb, r.args, r.deadline_s, r.rid, r.kind)
        return outcome(call)
    assert parse("port") == parse("ref")


# -- a seeded build under one rid ---------------------------------------------


def _resilient(side, tail, head, ladder=("host",), governor=None):
    rt = mod(side, "runtime")
    kw = {"device": "cpu"} if side == "port" else {}
    cfg = rt.RuntimeConfig(ladder=ladder, governor=governor)
    return rt.build_graph_resilient(tail, head, config=cfg, **kw)


def test_seeded_build_under_a_rid_records_as_the_reference(tmp_path):
    tail, head = rmat_edges(8, 4 << 8, seed=3)

    def run(side, t):
        with t.rid_scope(RID):
            _resilient(side, tail, head)
    got = traced(tmp_path, run)
    assert_same(got)
    recs = got["port"][1]
    assert all(r.get("rid") == RID for r in recs if r["k"] != "meta")
    assert {"ladder.plan", "rung.ok"} <= {r["name"] for r in recs
                                          if r["k"] == "ev"}


def _trace_cli(side, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod(side, "cli.trace").main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def _same_cli(argv):
    got = _trace_cli("port", argv)
    assert got == _trace_cli("ref", argv)
    return got


def test_trace_cli_rollup_and_rung_explanation_equal_reference(tmp_path):
    """Both tools on each package's trace of the same seeded build:
    equal stdout and ``--json``; the rung explanation names the rung."""
    tail, head = rmat_edges(8, 4 << 8, seed=3)
    got = traced(tmp_path, lambda side, t: _resilient(side, tail, head),
                 name="cli.trace")
    for side in PKGS:
        path = got[side][0]
        rc, out, _ = _same_cli([path])
        assert rc == 0
        for line in ("phase rollup", "ladder decisions", "ran: rung 'host'",
                     "timeline"):
            assert line in out
        rc, out, _ = _same_cli(["--json", path])
        rec = json.loads(out)
        assert rec["phases"]["rung"]["count"] == 1
        assert any("host" in line for line in rec["ladder"])
        _same_cli(["-m", "strict", "-n", "3", path])


def test_trace_cli_explains_governor_prices_as_the_reference(tmp_path):
    tail, head = rmat_edges(9, 4 << 9, seed=7)

    def run(side, t):
        G = mod(side, "resources.governor")
        prev = G.rss_bytes
        G.rss_bytes = lambda: 0
        try:
            n = 1 << 9
            budget = (G.rung_peak_nbytes("stream", 2 * n, 4 << 9)
                      + G.rung_peak_nbytes("host", 2 * n, 4 << 9)) // 2
            _resilient(side, tail, head, ("host", "stream", "spill"),
                       G.ResourceGovernor(mem_budget=budget))
        finally:
            G.rss_bytes = prev
    got = traced(tmp_path, run, name="gov.trace")
    assert_same(got)
    rc, out, _ = _same_cli([got["port"][0]])
    assert rc == 0 and "governor price" in out and "ran: rung" in out
    assert "-> skip" in out or "-> keep" in out


@pytest.mark.parametrize("argv", [[], ["-x"], ["-m", "bogus", "a"],
                                  ["/nonexistent.trace"],
                                  ["--merge", "/nonexistent-dir"]])
def test_trace_cli_errors_equal_reference(argv):
    _same_cli(argv)


def test_trace_cli_on_a_torn_trace_equals_reference(tmp_path):
    path = _sample_trace(tmp_path)
    with open(path, "ab") as f:
        f.write(b'{"k":')
    for argv in ([path], ["-m", "strict", path], ["--json", path]):
        _same_cli(argv)


# -- rotation and the segment chain -------------------------------------------


def test_rotation_seals_segments_as_the_reference(tmp_path):
    from sheep_tpu_torch.integrity.sidecar import read_sidecar

    got = traced(tmp_path, ticks("tick", 60, pad="x" * 40),
                 name="rot.trace", env={"SHEEP_TRACE_MAX_MB": "0.001"})
    assert_same(got)
    chains = {side: tr(side).trace_segments(got[side][0]) for side in PKGS}
    names = {side: [os.path.basename(p).split("-", 1)[1] for p in chain]
             for side, chain in chains.items()}
    assert names["port"] == names["ref"] and len(names["port"]) >= 3
    for seg in chains["port"][:-1]:
        assert tr("port").is_rotated_segment(seg)
        assert read_sidecar(seg) is not None
    recs = got["port"][1]
    assert sum(r["k"] == "span" for r in recs) == 60
    assert len({r["t0"] for r in recs if r["k"] == "meta"}) == 1


def test_fsck_segment_chain_torn_tail_rule_equals_reference(tmp_path):
    from sheep_tpu.integrity.fsck import fsck_file as ref_fsck
    from sheep_tpu_torch.integrity.fsck import fsck_file as port_fsck

    got = traced(tmp_path, ticks("tick", 60, pad="y" * 40),
                 name="chain.trace", env={"SHEEP_TRACE_MAX_MB": "0.001"})
    path = got["port"][0]
    seg = tr("port").trace_segments(path)[0]

    def both(p, mode):
        r = outcome(port_fsck, p, mode)
        assert r == outcome(ref_fsck, p, mode)
        return r
    assert "segment=rotated" in both(seg, "repair")[1]
    with open(path, "r+b") as f:
        f.seek(-5, os.SEEK_END)
        f.truncate()
    assert "torn_tail=truncatable" in both(path, "repair")[1]
    with open(seg, "r+b") as f:
        f.seek(-5, os.SEEK_END)
        f.truncate()
    os.unlink(seg + ".sum")
    assert both(seg, "repair")[0] == "MalformedArtifact"
    for mode in ("strict", "repair"):
        assert outcome(tr("port").read_trace_chain, path, mode) == \
            outcome(tr("ref").read_trace_chain, path, mode)


# -- merging many processes' traces by rid ------------------------------------


def _write_trace(path, wall_t0, recs):
    with open(path, "w") as f:
        f.write(json.dumps({"k": "meta", "v": 1, "pid": 1, "t0": wall_t0,
                            "argv": ["x"]}) + "\n")
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _merge_view(side, specs, mode="repair"):
    m = mod(side, "obs.merge")
    sources = m.load_sources(m.collect_trace_paths(specs), mode)
    m.estimate_offsets(sources)
    rids = m.merge_by_rid(sources)
    return (m.merged_json(sources, rids), m.render_merged(sources, rids),
            [(s.label, s.method, s.offset, s.bound) for s in sources])


def _router_and_daemon(d):
    _write_trace(os.path.join(d, "router.trace"), 1000.0, [
        {"k": "span", "name": "route.req", "id": i, "par": None,
         "t": float(i), "dur": 0.9, "rid": f"r{i}"} for i in range(3)])
    brecs = []
    for i in range(3):
        brecs.append({"k": "span", "name": "serve.req", "id": 10 + i,
                      "par": None, "t": 700.0 + i + 0.2, "dur": 0.5,
                      "rid": f"r{i}"})
        brecs.append({"k": "ev", "name": "wal.append", "par": 10 + i,
                      "t": 700.0 + i + 0.3, "rid": f"r{i}"})
    _write_trace(os.path.join(d, "daemon.trace"), 1800.0, brecs)


def test_merge_offsets_and_ordering_equal_reference(tmp_path):
    d = str(tmp_path)
    _router_and_daemon(d)
    got = _merge_view("port", [d])
    assert got == _merge_view("ref", [d])
    views = {label: (method, off, bound)
             for label, method, off, bound in got[2]}
    assert views["router"][0] == "reference"
    method, off, bound = views["daemon"]
    assert method.startswith("rid(") and bound is not None
    assert abs(off + 1500.2) <= bound + 0.21
    m = mod("port", "obs.merge")
    sources = m.load_sources(m.collect_trace_paths([d]))
    m.estimate_offsets(sources)
    for rid, recs in m.merge_by_rid(sources).items():
        assert [r["name"] for r in recs if r["_src"] == "daemon"] == \
            ["serve.req", "wal.append"]


def test_merge_without_shared_rids_equals_reference(tmp_path):
    a, b = str(tmp_path / "p1.trace"), str(tmp_path / "p2.trace")
    _write_trace(a, 100.0, [{"k": "span", "name": "x", "id": 1, "par": None,
                             "t": 0.0, "dur": 1.0, "rid": "aa"}])
    _write_trace(b, 200.0, [{"k": "span", "name": "y", "id": 1, "par": None,
                             "t": 0.0, "dur": 1.0, "rid": "bb"}])
    got = _merge_view("port", [a, b])
    assert got == _merge_view("ref", [a, b])
    assert [v[1] for v in got[2]] == ["reference", "wall"]
    assert got[2][1][3] is None


def test_collect_trace_paths_equals_reference(tmp_path):
    d = tmp_path / "fleet"
    (d / "sub").mkdir(parents=True)
    for name in ("a.trace", "b.0001.trace", "sub/c.trace", "x.txt"):
        (d / name).write_text("")
    for specs in ([str(d)], [str(d / "*.trace")], [str(d / "a.trace")],
                  [str(d), str(d / "a.trace")], [str(tmp_path / "none")]):
        assert mod("port", "obs.merge").collect_trace_paths(specs) == \
            mod("ref", "obs.merge").collect_trace_paths(specs)


def _serve_rids(tmp_path):
    """A serve store's inserts under rids in two "processes": a killed
    one and its restart, each with its own trace file."""
    from sheep_tpu_torch.io import write_dat
    tail, head = rmat_edges(7, 4 << 7, seed=3)
    g = str(tmp_path / "g.dat")
    write_dat(g, tail, head)
    d = str(tmp_path / "traces")
    os.makedirs(d)
    t = tr("port")
    S = mod("port", "serve")
    sd = str(tmp_path / "sd")
    os.environ[t.ENV] = os.path.join(d, "killed.trace")
    core = S.ServeCore.bootstrap(sd, graph_path=g, num_parts=2)
    S.faults.install_plan(S.faults.parse_serve_fault_plan(
        "kill@wal:3", kill_mode="raise"))
    try:
        for i in range(6):
            with t.rid_scope(f"ab{i:02x}"):
                core.insert(np.array([[i, i + 7]], np.uint32),
                            rid=f"ab{i:02x}")
    except S.ServeKilled:
        pass
    finally:
        S.faults.clear_plan()
    core.close()
    t.close_recorder()
    os.environ[t.ENV] = os.path.join(d, "restart.trace")
    core = S.ServeCore.open(sd)
    assert core.applied_seqno == 4  # the killed insert was durable
    with t.rid_scope("ab03"):
        t.event("client.recovered", seqno=core.applied_seqno)
    for i in range(4, 6):
        with t.rid_scope(f"ab{i:02x}"):
            core.insert(np.array([[i, i + 7]], np.uint32), rid=f"ab{i:02x}")
    core.close()
    t.close_recorder()
    os.environ.pop(t.ENV)
    return d


def test_trace_merge_cli_on_a_killed_store_equals_reference(tmp_path):
    d = _serve_rids(tmp_path)
    rc, out, _ = _same_cli(["--merge", d])
    assert rc == 0
    rc, out, _ = _same_cli(["--merge", "--json", d])
    rec = json.loads(out)
    assert len(rec["files"]) == 2
    _same_cli(["--merge", "--rid", "ab03", d])
    _same_cli(["--merge", "--rid", "nope", d])
    _same_cli(["--merge", "-n", "2", d])
    recs = {os.path.basename(p): tr("port").read_trace(p, "strict")[0]
            for p in (os.path.join(d, "killed.trace"),
                      os.path.join(d, "restart.trace"))}
    rids = {k: {r.get("rid") for r in v if r["k"] != "meta"} - {None}
            for k, v in recs.items()}
    assert rids["killed.trace"] & rids["restart.trace"] == {"ab03"}
    assert {r["src"] for r in rec["rids"]["ab03"]} == {"killed", "restart"}
