"""The port's command-line tools against the reference's, route by route.

Each case is a list of tool runs in a directory of its own.  The
reference runs as ``python -m sheep_tpu.cli.<tool>`` (JAX on one CPU
device, as tests/test_cli.py runs it); the port runs in process, as
``main(argv, device="cpu")`` for graph2tree and ``main(argv)`` for the
host-only tools.  Every run must print the same stdout less its timing
lines, exit with the same code, and the two directories must end up
holding the same files, byte for byte (sidecars included).

A job of one process joins through SHEEP_COORDINATOR
(``test_coordinator_joins_a_job_of_one``; two processes are
tests/test_torch_distributed.py's).  The external-memory, treewidth
and distext (local and shipped) routes and the ``plan`` tool are held
the same way in tests/test_torch_cli_routes.py, the routes on a mesh of
more than one worker in tests/test_torch_cli_mesh.py, each with this
file's helpers; ``route`` and ``top`` as processes are
tests/test_torch_router.py's.
"""

import contextlib
import io
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
