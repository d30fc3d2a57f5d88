"""The port's graph2tree routes that leave the host's in-RAM build, and
the ``plan`` tool, against the reference's (the split of
tests/test_torch_cli.py that keeps each file on one worker short).

Each case runs as tests/test_torch_cli.py runs its cases (``_run_steps``):
the reference as ``python -m sheep_tpu.cli.<tool>``, the port in process,
the same stdout less its timing lines, the same exit codes and the same
file bytes.  The external-memory and treewidth routes
(``test_ext_and_jxn_routes_equal_reference``; a memory budget routes by
the headroom over the process's RSS, so those cases pin the RSS both
packages read), the ``plan`` tool (``test_plan_equals_reference``), the
distributed out-of-core build, whose legs are processes of their own
(``test_distext_routes_equal_reference``), the same with its legs
shipped to a remote worker daemon
(``test_shipped_distext_route_equals_reference``).  The device routes on
a mesh of more than one worker are tests/test_torch_cli_mesh.py's.
"""

import json
import os

import pytest

from test_torch_cli import G, REPO, SEQ, T, _run_steps, run_port


#: the RSS both packages' governors read in the budgeted cases: a budget
#: of PINNED_RSS + room leaves ``room`` bytes of headroom
PINNED_RSS = 1 << 27
#: headroom that holds the ext rung's floor block (64 B x 2^14 records)
#: but not the in-RAM load (24 B a record) of R-MAT 2^14 x 8
EXT_ROOM = 2 << 20

#: the external-memory and treewidth routes: id -> (steps, pin the RSS)
EXT_JXN = {
    "jxn_kids": ([G("-k", "-f")], False),
    "jxn_width": ([G("-w", "3", "-f", "-o", "t.tre")], False),
    "jxn_mesh": ([G("-i", "-r", "-x", "-f")], False),
    "jxn_kej_validate": ([G("-k", "-e", "-j", "-f", "-c")], False),
    "jxn_ir_kej": ([G("-i", "-r", "-k", "-e", "-j", "-f", "-c", "-o",
                      "t.tre")], False),
    "jxn_i_seq_write": ([G("-i", "-k", "-e", "-j", "-s", "i.seq", "-f")],
                        False),
    "jxn_seq_given_max_width": ([SEQ, G("-s", "s.seq", "-k", "-e", "-j",
                                        "-x", "-w", "40", "-f")], False),
    "jxn_memory_limit": ([G("-k", "-e", "-j", "-m", "1", "-f")], False),
    "jxn_print_tree": ([T("make_graph", "7", "2", "g.dat", "3"),
                        T("graph2tree", "g.dat", "-e", "-t")], False),
    "ext_flag": ([G("--ext", "-f", "-o", "t.tre")], False),
    "ext_env": ([G("-f", "-o", "t.tre", env={"SHEEP_EXT_BLOCK": "4096"})],
                False),
    "ext_budget": ([T("make_graph", "14", "8", "g.dat", "1"),
                    T("graph2tree", "g.dat", "-f", "-o", "t.tre",
                      env={"SHEEP_MEM_BUDGET": str(PINNED_RSS + EXT_ROOM)})],
                   True),
    # below the floor block the reference picks its distributed build;
    # without -o that falls back, and the budget then routes to ext
    "ext_budget_distext_fallback": (
        [G("-f", env={"SHEEP_MEM_BUDGET": str(PINNED_RSS + 300_000)})],
        True),
    "ext_seq_given_validate": ([SEQ, G("--ext", "-s", "s.seq", "-o",
                                       "t.tre", "-f", "-c", "-v")], False),
    "ext_partition_print": ([G("--ext", "-p", "2")], False),
    "ext_checkpoint": ([G("--ext", "--checkpoint-dir", "ck", "-o", "t.tre",
                          env={"SHEEP_EXT_BLOCK": "3000"})], False),
    "ext_equals_ram": ([G("-o", "ram.tre"),
                        G("--ext", "-o", "ext.tre",
                          env={"SHEEP_EXT_BLOCK": "1000",
                               "SHEEP_EXT_STRATEGY": "links"})], False),
}


@pytest.mark.parametrize("case", sorted(EXT_JXN))
def test_ext_and_jxn_routes_equal_reference(tmp_path, monkeypatch, case):
    """The routes that raised until ops/extmem.py and core/jxn.py came
    over: the same stdout, exit codes and file bytes as the reference."""
    steps, pin = EXT_JXN[case]
    got = _run_steps(tmp_path, steps, rss=PINNED_RSS if pin else None,
                     monkeypatch=monkeypatch)
    if case == "ext_equals_ram":
        assert got["ext.tre"] == got["ram.tre"]


def test_ext_budget_routes_to_ext_without_the_flag(tmp_path, monkeypatch):
    """Under a pinned RSS the budget alone sends the port to the ext
    route, and without the budget to the in-RAM build; both write the
    same tree."""
    from sheep_tpu_torch.ops import extmem
    from sheep_tpu_torch.resources import governor
    monkeypatch.setattr(governor, "rss_bytes", lambda: PINNED_RSS)
    calls = []
    real = extmem.build_forest_extmem
    monkeypatch.setattr(extmem, "build_forest_extmem",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    rc, _ = run_port("make_graph", ["14", "8", "g.dat", "1"], {},
                     str(tmp_path))
    assert rc == 0
    graph = str(tmp_path / "g.dat")
    for name, budget in (("ext", str(PINNED_RSS + EXT_ROOM)), ("ram", "")):
        env = {"SHEEP_MEM_BUDGET": budget} if budget else {}
        d = tmp_path / name
        d.mkdir()
        rc, _ = run_port("graph2tree", [graph, "-o", "t.tre"], env, str(d))
        assert rc == 0
        assert len(calls) == 1  # the budgeted run only
    assert open(tmp_path / "ext" / "t.tre", "rb").read() == \
        open(tmp_path / "ram" / "t.tre", "rb").read()


_TRACE = [
    {"k": "meta", "v": 1, "pid": 1, "t0": 0.0, "argv": []},
    {"k": "ev", "name": "ladder.plan", "t": 0.1,
     "a": {"n": 7610, "links": 15751, "rss_bytes": 50_000_000}},
    {"k": "ev", "name": "rung.ok", "t": 0.2,
     "a": {"rung": "host", "est_bytes": 400_000, "rss_bytes": 50_300_000,
           "n": 7610}},
    {"k": "span", "name": "rung", "id": 1, "par": 0, "tid": 1, "t": 0.1,
     "dur": 0.25, "a": {"rung": "host", "links": 15751}},
    {"k": "span", "name": "rung", "id": 2, "par": 0, "tid": 1, "t": 0.4,
     "dur": 0.5, "a": {"rung": "ext", "links": 15751}},
]

#: the plan tool: id -> steps
PLAN = {
    "explain_hypothetical": [T("plan", "--explain", "-n", "1048576", "-e",
                               "4194304", "--assume-rss", "100000000",
                               env={"SHEEP_MEM_BUDGET": "192M"})],
    "explain_unbudgeted": [T("plan", "--explain", "-n", "4096", "-w", "2")],
    "explain_default_edges": [T("plan", "-n", "65536", "--assume-rss", "0",
                                env={"SHEEP_MEM_BUDGET": "8M"})],
    "explain_dat": [T("make_graph", "10", "4", "g.dat", "5"),
                    T("plan", "--explain", "--assume-rss", "150000000",
                      "g.dat", env={"SHEEP_MEM_BUDGET": "192M"})],
    "explain_dat_pinned_block": [
        T("make_graph", "10", "4", "g.dat", "5"),
        T("plan", "--assume-rss", "1000", "g.dat",
          env={"SHEEP_MEM_BUDGET": "64M", "SHEEP_EXT_BLOCK": "2M",
               "SHEEP_DISTEXT_LEGS": "3"})],
    "json_dat": [T("make_graph", "10", "4", "g.dat", "5"),
                 T("plan", "--json", "--assume-rss", "190000000", "g.dat",
                   env={"SHEEP_MEM_BUDGET": "192M"})],
    "json_hypothetical": [T("plan", "--json", "-n", "1048576", "-e",
                            "67108864", "--assume-rss", "1000000",
                            env={"SHEEP_MEM_BUDGET": "1G",
                                 "SHEEP_HANDOFF_WINDOWS": "3",
                                 "SHEEP_PIPELINE_CHUNKS": "0"})],
    "harvest_then_explain": [
        T("plan", "--harvest", "p.store", "{trace}", "{bench}"),
        T("plan", "--explain", "--priors", "p.store", "-n", "7610", "-e",
          "15751", "--assume-rss", "0", env={"SHEEP_MEM_BUDGET": "1G"})],
    "harvest_missing": [T("plan", "--harvest", "p.store", "nope.trace")],
    "harvest_usage": [T("plan", "--harvest", "p.store")],
    "not_dat": [T("make_graph", "8", "2", "g.net"),
                T("plan", "--explain", "g.net")],
    "missing_file": [T("plan", "--explain", "nope.dat")],
    "two_inputs": [T("plan", "a.dat", "b.dat")],
    "usage": [T("plan")],
    "bad_option": [T("plan", "-q")],
}


@pytest.mark.parametrize("case", sorted(PLAN))
def test_plan_equals_reference(tmp_path, monkeypatch, case):
    """``plan`` prints the reference's plan (RSS pinned by
    --assume-rss), harvests the same priors into the same store bytes,
    and exits with its codes."""
    import json
    trace = tmp_path / "run.trace"
    trace.write_text("".join(json.dumps(r) + "\n" for r in _TRACE))
    files = {"trace": str(trace),
             "bench": os.path.join(REPO, "EXTBENCH_r01.json")}
    steps = [(tool, [a.format(**files) for a in argv], env)
             for tool, argv, env in PLAN[case]]
    # the thread veto and the jump-table depth read the live RSS, which
    # --assume-rss does not pin: pin it in both processes
    _run_steps(tmp_path, steps, rss=PINNED_RSS, monkeypatch=monkeypatch)


#: the distributed out-of-core build (its legs are processes of their
#: own): id -> (steps, pin the RSS)
DISTEXT = {
    # SHEEP_LEG_CORES past the host's cores: the planner's floor of 2 legs
    "distext_flag": ([G("--distext", "-o", "t.tre",
                        env={"SHEEP_LEG_CORES": "1024"})], False),
    "distext_env_verbose": ([G("-o", "t.tre", "-v", "-f",
                               env={"SHEEP_DISTEXT_LEGS": "3"})], False),
    # a headroom below the ext rung's floor block routes to distext
    "distext_budget": ([G("-o", "t.tre", env={
        "SHEEP_MEM_BUDGET": str(PINNED_RSS + 300_000),
        "SHEEP_LEG_CORES": "1024"})], True),
    "distext_checkpoint_dir_rerun": (
        [G("--distext", "--checkpoint-dir", "ck", "-o", "t.tre",
           env={"SHEEP_DISTEXT_LEGS": "2"}),
         G("--distext", "--checkpoint-dir", "ck", "-o", "t.tre",
           env={"SHEEP_DISTEXT_LEGS": "2"})], False),
    "distext_chaos": ([G("--distext", "-o", "t.tre", env={
        "SHEEP_DISTEXT_LEGS": "2",
        "SHEEP_FAULT_PLAN": "kill@-2:1,corrupt@0:0"})], False),
}


@pytest.mark.parametrize("case", sorted(DISTEXT))
def test_distext_routes_equal_reference(tmp_path, monkeypatch, case):
    """The routes that raised until ops/distext.py and supervisor/ came
    over: the same exit codes, stdout, and state-dir and tree bytes (the
    manifest, sidecars, histograms and partial trees) as the reference,
    each leg a process of its own."""
    steps, pin = DISTEXT[case]
    got = _run_steps(tmp_path, steps, rss=PINNED_RSS if pin else None,
                     monkeypatch=monkeypatch)
    state = "ck" if "checkpoint" in case else "t.tre.distext"
    assert got["t.tre"] == got[os.path.join(state, "hep-th.tre")]
    legs = json.loads(got[os.path.join(state, "manifest.json")])["legs"]
    dispatches = {leg["key"]: leg["dispatches"] for leg in legs}
    if case == "distext_chaos":
        assert dispatches["h.01"] == dispatches["r0.00"] == 2
    else:
        assert set(dispatches.values()) == {1}


#: the distext route with its legs shipped to a remote worker daemon:
#: (argv, env; ``{addr}`` is the worker's host:port)
SHIPPED = {
    "distext_ship": (["--distext", "-o", "t.tre"],
                     {"SHEEP_DISTEXT_LEGS": "2",
                      "SHEEP_WORKER_ADDRS": "{addr}",
                      "SHEEP_WORKER_TRANSPORT": "ship"}),
}


@pytest.mark.parametrize("case", sorted(SHIPPED))
def test_shipped_distext_route_equals_reference(tmp_path, case):
    """``graph2tree --distext`` pinned to ship, each package's run shipping
    its hist and map legs to one port worker daemon (the reference's
    supervisor, a process of its own, ships to it over the wire too),
    with the same exit code, stdout, tree, manifest and leg files as the
    reference's; every leg dispatched once."""
    from sheep_tpu_torch.serve.worker import WorkerDaemon

    argv, env = SHIPPED[case]
    worker = WorkerDaemon(str(tmp_path / "w")).start()
    try:
        addr = "{}:{}".format(*worker.address)
        env = {k: v.replace("{addr}", addr) for k, v in env.items()}
        (tmp_path / "runs").mkdir()
        got = _run_steps(tmp_path / "runs", [G(*argv, env=env)])
    finally:
        worker.shutdown()
    state = "t.tre.distext"
    assert got["t.tre"] == got[os.path.join(state, "hep-th.tre")]
    legs = json.loads(got[os.path.join(state, "manifest.json")])["legs"]
    assert {leg["dispatches"] for leg in legs} == {1}
    wires = [k for k in got if os.path.basename(k).startswith("wire-")]
    assert len(wires) == 4, wires  # 2 hist + 2 map legs went remote
    assert any(n.endswith(".slice.dat")
               for n in os.listdir(tmp_path / "w"))
