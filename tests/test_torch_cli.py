"""The port's command-line tools against the reference's, route by route.

Each case is a list of tool runs in a directory of its own.  The
reference runs as ``python -m sheep_tpu.cli.<tool>`` (JAX on one CPU
device, as tests/test_cli.py runs it); the port runs in process, as
``main(argv, device="cpu")`` for graph2tree and ``main(argv)`` for the
host-only tools.  Every run must print the same stdout less its timing
lines, exit with the same code, and the two directories must end up
holding the same files, byte for byte (sidecars included).

The external-memory and treewidth routes, which raised until their
modules came over, are held against the reference the same way
(``test_ext_and_jxn_routes_equal_reference``; a memory budget routes by
the headroom over the process's RSS, so those cases pin the RSS both
packages read).  The distributed out-of-core build, whose legs are
processes of their own, is held the same way
(``test_distext_routes_equal_reference``).  The ``plan`` tool is held
against the reference's (``test_plan_equals_reference``).  The device routes on a mesh of more
than one worker run the reference on that many CPU devices and the port
on that many CPU workers (``test_mesh_route_equals_reference``); a job
of one process joins through SHEEP_COORDINATOR
(``test_coordinator_joins_a_job_of_one``; two processes are
tests/test_torch_distributed.py's).  The distext route with its legs
shipped to a remote worker daemon, which raised until the remote
workers came over, is held the same way (``test_unported_route_raises``,
the name it kept).
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")

#: files whose bytes name a process or a clock (heartbeats, the distext
#: legs' self-reports)
_VOLATILE = (".hb", ".perf.json")


def ref_env(extra: dict, devices: int = 1) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    # one CPU device by default: a mesh of one worker, as on one card
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", ""))
    env["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={devices}"
    ).strip()
    for k in [k for k in env if k.startswith("SHEEP_")]:
        del env[k]
    env.update(extra)
    return env


def stable_lines(out: str) -> list:
    """stdout less the timing lines, the supervisor's phase times masked
    (``Mapped in 1.23 seconds.``)."""
    return [re.sub(r" in [0-9.]+ seconds\.$", " in T seconds.", ln)
            for ln in out.splitlines()
            if " in: " not in ln and " took: " not in ln]


def run_ref(tool: str, argv: list, env: dict, cwd: str,
            rss: int | None = None, devices: int = 1):
    """The reference's tool as a subprocess on ``devices`` CPU devices;
    ``rss`` pins the RSS its governor reads
    (``resources.governor.rss_bytes``)."""
    if rss is None:
        cmd = ["-m", f"sheep_tpu.cli.{tool}"]
    else:
        cmd = ["-c", "import sys\n"
               "import sheep_tpu.resources.governor as g\n"
               f"g.rss_bytes = lambda: {rss}\n"
               f"from sheep_tpu.cli.{tool} import main\n"
               "sys.exit(main(sys.argv[1:]))\n"]
    proc = subprocess.run(
        [sys.executable] + cmd + argv, capture_output=True, text=True,
        timeout=300, env=ref_env(env, devices), cwd=cwd)
    return proc.returncode, proc.stdout, proc.stderr


@contextlib.contextmanager
def port_env(extra: dict):
    saved = {k: v for k, v in os.environ.items() if k.startswith("SHEEP_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(extra)
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("SHEEP_")]:
            del os.environ[k]
        os.environ.update(saved)


def run_port(tool: str, argv: list, env: dict, cwd: str):
    import importlib
    mod = importlib.import_module(f"sheep_tpu_torch.cli.{tool}")
    kw = {"device": "cpu"} if tool == "graph2tree" else {}
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with port_env(env), contextlib.redirect_stdout(out):
            try:
                rc = mod.main(list(argv), **kw)
            except SystemExit as exc:
                rc = exc.code if isinstance(exc.code, int) else 1
            except Exception as exc:  # an uncaught error exits 1
                rc = 1
                print(f"<{type(exc).__name__}>", file=sys.stderr)
    finally:
        os.chdir(old)
    return rc, out.getvalue()


def flip(path: str, offset: int) -> None:
    data = bytearray(open(path, "rb").read())
    data[offset] ^= 0xFF
    open(path, "wb").write(bytes(data))


def tree(path: str) -> dict:
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            out[rel] = None if name.endswith(_VOLATILE) else \
                open(full, "rb").read()
    return out


def G(*argv, env=None):
    return ("graph2tree", [HEP, *argv], env or {})


def T(tool, *argv, env=None):
    return (tool, list(argv), env or {})


SEQ = T("degree_sequence", HEP, "s.seq")
WHOLE = G("-s", "s.seq", "-o", "t.tre")

#: id -> steps; a step is (tool, argv, env) or ("!flip", [file, offset], {})
CASES = {
    # graph2tree, serial (host) routes
    "serial_facts_validate": [G("-f", "-c", "-o", "t.tre")],
    "serial_verbose": [G("-v", "-f")],
    "serial_print_tree": [G("-t")],
    "serial_seq_given": [SEQ, G("-s", "s.seq", "-o", "t.tre", "-f", "-c")],
    "serial_partial_loads": [SEQ, G("-l", "1/2", "-s", "s.seq", "-o",
                                    "p1.tre", "-f"),
                             G("-l", "2/2", "-s", "s.seq", "-o", "p2.tre")],
    "serial_partition_print": [G("-p", "2")],
    "serial_partition_write": [G("-p", "3", "-o", "part")],
    "serial_heartbeat": [G("-f", env={"SHEEP_HEARTBEAT_FILE": "{d}/w.hb",
                                      "SHEEP_HEARTBEAT_S": "3600"})],
    "serial_ddup": [G("-f", "-o", "t.tre", env={"SHEEP_DDUP_GRAPH": "1"})],
    # graph2tree, device routes (one worker)
    "ir_facts_validate": [G("-i", "-r", "-f", "-c", "-o", "t.tre")],
    "ir_seq_write": [G("-i", "-r", "-s", "i.seq", "-o", "t.tre", "-v")],
    "r_seq_given": [SEQ, G("-r", "-s", "s.seq", "-o", "t.tre", "-f")],
    "i_partition_print": [G("-i", "-p", "2", "-f")],
    "ir_partition_write": [G("-i", "-r", "-p", "2", "-o", "part")],
    "ir_ignores_partial_load": [G("-i", "-r", "-l", "1/2", "-f")],
    "i_map_one_worker": [G("-i", "-s", "i.seq", "-o", "P", "-f", "-c",
                           env={"SHEEP_WORKERS": "1"})],
    "i_map_host_partials": [G("-i", "-s", "i.seq", "-o", "P", "-f",
                              env={"SHEEP_WORKERS": "3"})],
    "checkpoint_serial": [G("--checkpoint-dir", "ck", "-o", "t.tre", "-f")],
    "checkpoint_ir": [G("-i", "-r", "--checkpoint-dir", "ck", "-o",
                        "t.tre", "-f", "--max-retries", "2")],
    "checkpoint_env": [G("-i", "-r", "-o", "t.tre",
                         env={"SHEEP_CHECKPOINT_DIR": "{d}/ck"})],
    "selfcheck_off": [G("-i", "-r", "-f", env={"SHEEP_SELFCHECK": "0"})],
    # serial = -r = -ir = -i + merge_trees (test_cli.py's equivalence)
    "path_equivalence": [
        SEQ, G("-s", "s.seq", "-o", "serial.tre"),
        G("-r", "-s", "s.seq", "-o", "r.tre"),
        G("-i", "-r", "-o", "ir.tre"),
        G("-i", "-s", "i.seq", "-o", "i", env={"SHEEP_WORKERS": "2"}),
        T("merge_trees", "i00r0.tre", "i01r0.tre", "-o", "i.tre", "-f")],
    # graph2tree, the fallbacks that stay in process and the errors
    "ext_falls_back_for_partitions": [G("--ext", "-p", "2", "-o", "part")],
    "distext_needs_output": [G("--distext", "-f")],
    "usage": [("graph2tree", [], {})],
    "bad_option": [G("-q")],
    "missing_argument": [G("-s")],
    "resume_needs_checkpoint": [G("--resume")],
    "checksum_mismatch_strict": [T("make_graph", "9", "4", "g.dat", "2"),
                                 ("!flip", ["g.dat", 5], {}),
                                 T("graph2tree", "g.dat", "-f")],
    "checksum_mismatch_repair": [T("make_graph", "9", "4", "g.dat", "2"),
                                 ("!flip", ["g.dat", 5], {}),
                                 T("graph2tree", "g.dat", "-f",
                                   env={"SHEEP_INTEGRITY": "repair"})],
    # make_graph and degree_sequence
    "make_graph_dat": [T("make_graph", "10", "4", "g.dat", "5"),
                       T("degree_sequence", "g.dat", "g.seq")],
    "make_graph_net_default_seed": [T("make_graph", "8", "2", "g.net"),
                                    T("degree_sequence", "g.net", "g.seq"),
                                    T("graph2tree", "g.net", "-f", "-o",
                                      "g.tre")],
    "make_graph_usage": [T("make_graph", "8")],
    "degree_sequence_hep": [SEQ],
    "degree_sequence_ddup": [T("degree_sequence", HEP, "s.seq",
                               env={"SHEEP_DDUP_GRAPH": "1"})],
    "degree_sequence_usage": [T("degree_sequence", HEP)],
    # partition_tree
    "partition_evaluate": [SEQ, WHOLE,
                           T("partition_tree", "-f", "-g", HEP, "s.seq",
                             "t.tre", "2", "3")],
    "partition_only_print": [SEQ, WHOLE,
                             T("partition_tree", "s.seq", "t.tre", "2", "5",
                               "-u")],
    "partition_write": [SEQ, WHOLE,
                        T("partition_tree", "-g", HEP, "-o", "pp", "s.seq",
                          "t.tre", "4")],
    "partition_streamed": [SEQ, WHOLE,
                           T("partition_tree", "-g", HEP, "s.seq",
                             "t.tre", "2", "9",
                             env={"SHEEP_EVAL_STREAM": "1"})],
    "partition_streamed_threshold": [
        SEQ, WHOLE,
        T("partition_tree", "-g", HEP, "s.seq", "t.tre", "2",
          env={"SHEEP_EVAL_STREAM_THRESHOLD": "100"})],
    "partition_weights_balance": [SEQ, WHOLE,
                                  T("partition_tree", "-x", "-d", "-b",
                                    "1.1", "-v", "-g", HEP, "s.seq",
                                    "t.tre", "3")],
    "partition_pre_weights": [SEQ, WHOLE,
                              T("partition_tree", "-u", "-g", HEP, "s.seq",
                                "t.tre", "2")],
    "partition_seq_from_graph": [SEQ, WHOLE,
                                 T("partition_tree", "-g", HEP, "-", "t.tre",
                                   "2")],
    "partition_usage": [T("partition_tree", "s.seq")],
    # merge_trees
    "merge_refuses_node_counts": [
        T("make_graph", "9", "4", "g.dat", "2"),
        T("graph2tree", "g.dat", "-o", "a.tre"), G("-o", "b.tre"),
        T("merge_trees", "a.tre", "b.tre", "-o", "m.tre")],
    "merge_expect_sig": [SEQ, G("-l", "1/2", "-s", "s.seq", "-o", "p1.tre"),
                         G("-l", "2/2", "-s", "s.seq", "-o", "p2.tre"),
                         T("merge_trees", "p1.tre", "p2.tre", "-o", "m.tre",
                           "--expect-sig", "0" * 64)],
    "merge_verbose": [SEQ, G("-l", "1/3", "-s", "s.seq", "-o", "p1.tre"),
                      G("-l", "2/3", "-s", "s.seq", "-o", "p2.tre"),
                      G("-l", "3/3", "-s", "s.seq", "-o", "p3.tre"),
                      T("merge_trees", "-v", "-k", "-f", "p1.tre", "p2.tre",
                        "p3.tre", "-o", "m.tre")],
    "merge_usage": [T("merge_trees", "a.tre")],
    # fsck
    "fsck_dir": [SEQ, WHOLE, T("fsck", ".")],
    "fsck_corrupt_quiet": [SEQ, WHOLE, ("!flip", ["t.tre", 9], {}),
                           T("fsck", "-q", ".")],
    "fsck_reseal": [SEQ, WHOLE, ("!flip", ["t.tre", 9], {}),
                    T("fsck", "-R", "t.tre"), T("fsck", "t.tre")],
    "fsck_usage": [T("fsck", "-m", "lenient", "x")],
}


def _run_steps(tmp_path, steps, rss=None, monkeypatch=None, devices=1):
    """Run ``steps`` through both packages in directories of their own and
    hold stdout, exit codes and the files they leave equal; returns the
    port's files.  ``rss`` pins the RSS both governors read (the
    reference's in its subprocess, the port's here).  ``devices``: the
    reference's CPU devices and the port's CPU mesh workers
    (``parallel.mesh.mesh_devices`` patched)."""
    if rss is not None:
        from sheep_tpu_torch.resources import governor
        monkeypatch.setattr(governor, "rss_bytes", lambda: rss)
    if devices != 1:
        from sheep_tpu_torch.parallel import mesh
        monkeypatch.setattr(mesh, "mesh_devices",
                            lambda device: [torch.device("cpu")] * devices)
    dirs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        dirs[side] = str(d)
    for i, (tool, argv, env) in enumerate(steps):
        if tool == "!flip":
            for d in dirs.values():
                flip(os.path.join(d, argv[0]), argv[1])
            continue
        rc, out, err = run_ref(tool, argv, {k: v.format(d=dirs["ref"])
                                            for k, v in env.items()},
                               dirs["ref"], rss=rss, devices=devices)
        prc, pout = run_port(tool, argv, {k: v.format(d=dirs["port"])
                                          for k, v in env.items()},
                             dirs["port"])
        where = f"step {i} ({tool} {' '.join(argv)})"
        assert prc == rc, f"{where}: exit {prc} != {rc}\n{err}"
        assert stable_lines(pout) == stable_lines(out), where
    want, got = tree(dirs["ref"]), tree(dirs["port"])
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], f"{rel} differs"
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_reference(tmp_path, case):
    got = _run_steps(tmp_path, CASES[case])
    if case == "path_equivalence":
        serial = got["serial.tre"]
        for name in ("r.tre", "ir.tre", "i.tre"):
            assert got[name] == serial, name


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
def test_unported_route_raises(tmp_path, case):
    """The route that raised until the remote workers came over:
    ``graph2tree --distext`` pinned to ship, each package's run shipping
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


#: the device routes on a mesh of more than one worker: id -> (CPU
#: devices of the reference, CPU workers of the port, steps)
MESH_CASES = {
    "mesh_of_two": (2, [G("-i", "-r", "-f", "-c", "-o", "t.tre",
                          env={"SHEEP_WORKERS": "2"})]),
    "map_mesh_of_two": (2, [G("-i", "-s", "i.seq", "-o", "P", "-f", "-c",
                              env={"SHEEP_WORKERS": "2"})]),
    "mesh_of_three": (3, [G("-i", "-r", "-f", "-o", "t.tre")]),
    "workers_capped_by_devices": (2, [G("-i", "-r", "-f", "-o", "t.tre",
                                        env={"SHEEP_WORKERS": "8"})]),
    "map_more_workers_than_devices": (
        2, [G("-i", "-s", "i.seq", "-o", "P", "-f",
              env={"SHEEP_WORKERS": "3"})]),
    "mesh_given_seq": (2, [SEQ, G("-r", "-s", "s.seq", "-o", "t.tre",
                                  "-f")]),
    "mesh_loop_kernel": (2, [G("-i", "-r", "-f", "-o", "t.tre",
                               env={"SHEEP_MESH_KERNEL": "loop"})]),
    "mesh_partition_write": (2, [G("-i", "-r", "-p", "2", "-o", "part")]),
    "mesh_checkpoint": (2, [G("-i", "-r", "--checkpoint-dir", "ck", "-o",
                              "t.tre", "-f")]),
    "mesh_merge_partials": (3, [G("-i", "-s", "i.seq", "-o", "i"),
                                T("merge_trees", "i00r0.tre", "i01r0.tre",
                                  "i02r0.tre", "-o", "i.tre", "-f")]),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_route_equals_reference(tmp_path, monkeypatch, case):
    """A mesh of more than one worker (the reference on that many CPU
    devices, the port on that many CPU workers): the same stdout, exit
    codes and file bytes, the map route's per-worker partial trees
    included."""
    devices, steps = MESH_CASES[case]
    got = _run_steps(tmp_path, steps, monkeypatch=monkeypatch,
                     devices=devices)
    if case.startswith("map_mesh"):
        assert sorted(k for k in got if k.endswith("r0.tre")) == \
            ["P00r0.tre", "P01r0.tre"]


def test_coordinator_joins_a_job_of_one(tmp_path):
    """SHEEP_COORDINATOR with one process: graph2tree joins the job
    (gloo at world size 1 on the CPU) and builds the tree the serial
    route builds, byte for byte."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    env = ref_env({"SHEEP_COORDINATOR": coord, "SHEEP_NUM_PROCESSES": "1",
                   "SHEEP_PROCESS_ID": "0"})
    prog = ("import sys\n"
            "from sheep_tpu_torch.cli.graph2tree import main\n"
            "sys.exit(main(sys.argv[1:], device='cpu'))\n")
    proc = subprocess.run(
        [sys.executable, "-c", prog, HEP, "-i", "-r", "-f", "-o", "d.tre"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Mapped in:" in proc.stdout
    rc, out, err = run_ref("graph2tree", [HEP, "-f", "-o", "s.tre"], {},
                           str(tmp_path))
    assert rc == 0, err
    assert (tmp_path / "d.tre").read_bytes() == \
        (tmp_path / "s.tre").read_bytes()
    assert [ln for ln in proc.stdout.splitlines() if "TREEFAQS" in ln] == \
        [ln for ln in out.splitlines() if "TREEFAQS" in ln]


def test_device_routes_need_cuda_unless_named(tmp_path):
    """-i/-r and the checkpoint routes run on the card: without CUDA and
    without device="cpu" they raise, in process and as a tool."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.cli import graph2tree

    for argv in (["-i", "-r"], ["-r"], ["-i", "-o", str(tmp_path / "P")],
                 ["--checkpoint-dir", str(tmp_path / "ck")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graph2tree.main([HEP, *argv])
    env = ref_env({})
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.graph2tree", HEP, "-i",
         "-r", "-f"], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "TREEFAQS" not in proc.stdout
    # the host-only routes stand alone as plain tools
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.graph2tree", HEP, "-f"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "TREEFAQS: width:24\troots:581" in proc.stdout
