"""The port's multi-process mesh on the CPU: two processes joined through
``parallel.init_distributed`` over gloo, one CPU worker each, against the
reference's single-process mesh of two workers (its 8-device virtual CPU
mesh), bit for bit; ``graph2tree -i -r`` under SHEEP_COORDINATOR,
SHEEP_NUM_PROCESSES and SHEEP_PROCESS_ID; and the unreachable
coordinator's error (the port of tests/test_runtime.py's
``test_init_distributed_unreachable_coordinator_times_out``).

Every subprocess has a timeout of its own.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import sheep_tpu.parallel as ref_par

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
TIMEOUT = 240

sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_distributed_worker import graph  # noqa: E402


def free_coordinator() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def env_for(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in [k for k in env if k.startswith("SHEEP_")]:
        del env[k]
    env.update(extra or {})
    return env


def run_all(cmds: list, envs: list, cwds: list | None = None):
    """Start every command at once; wait for each within TIMEOUT (killing
    all on a timeout); return their (rc, stdout, stderr)."""
    cwds = cwds or [None] * len(cmds)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e,
                              cwd=d)
             for c, e, d in zip(cmds, envs, cwds)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


@pytest.fixture(scope="module")
def two_process_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    coord = free_coordinator()
    outs = run_all([[sys.executable, WORKER, coord, "2", str(r), str(d)]
                    for r in range(2)], [env_for(), env_for()])
    for rc, out, err in outs:
        assert rc == 0, out + err
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def test_two_process_collectives(two_process_results):
    for got in two_process_results:
        assert got["psum"].tolist() == [3, 19]
        assert got["pmin"].tolist() == [1, 9]
        assert got["pmax"].tolist() == [2, 10]
        assert got["gather"].tolist() == [[1, 10], [2, 9]]


def test_two_processes_equal_the_reference_mesh_of_two(two_process_results):
    """Both processes hold the reference's W = 2 results: the chunked
    build with its rounds and comm model, a given sequence, each map-only
    partial, the loop twin and both streaming builds."""
    from sheep_tpu.core.sequence import degree_sequence, sequence_positions
    from sheep_tpu.parallel.chunked import (build_links_chunked_sharded,
                                            stage_edges_2d)

    tail, head = graph()
    seq, ref = ref_par.build_graph_distributed(tail, head, num_workers=2)
    n = int(max(tail.max(), head.max())) + 1
    mesh = ref_par.make_mesh(2)
    t2d, h2d = stage_edges_2d(tail, head, n, mesh)
    tm, comm = {}, {}
    build_links_chunked_sharded(t2d, h2d, n, mesh, timings=tm, comm=comm)
    given = degree_sequence(tail, head)[:-5]
    _, ref_given = ref_par.build_graph_distributed(tail, head, seq=given,
                                                   num_workers=2)
    _, ref_parts = ref_par.map_graph_distributed(tail, head, num_workers=2)
    pos = sequence_positions(seq, int(max(tail.max(), head.max())))
    block = 700

    def blocks():
        return ((tail[a:a + block], head[a:a + block])
                for a in range(0, len(tail), block))

    ref_sc, ref_sc_rounds = ref_par.build_graph_streaming_chunked(
        blocks(), len(seq), pos, block, num_workers=2)
    ref_ss, ref_ss_rounds = ref_par.build_graph_streaming_sharded(
        blocks(), len(seq), pos, block, num_workers=2)
    for got in two_process_results:
        np.testing.assert_array_equal(got["seq"], seq)
        np.testing.assert_array_equal(got["parent"], ref.parent)
        np.testing.assert_array_equal(got["pst"], ref.pst_weight)
        assert json.loads(got["timings"].tobytes()) == {
            "map_rounds": tm["map_rounds"],
            "reduce_rounds": tm["reduce_rounds"]}
        assert json.loads(got["comm"].tobytes()) == comm
        np.testing.assert_array_equal(got["given_parent"], ref_given.parent)
        np.testing.assert_array_equal(got["given_pst"],
                                      ref_given.pst_weight)
        for i, p in enumerate(ref_parts):
            np.testing.assert_array_equal(got[f"map{i}_parent"], p.parent)
            np.testing.assert_array_equal(got[f"map{i}_pst"], p.pst_weight)
        np.testing.assert_array_equal(got["loop_parent"], ref.parent)
        np.testing.assert_array_equal(got["loop_pst"], ref.pst_weight)
        np.testing.assert_array_equal(got["schunk_parent"], ref_sc.parent)
        np.testing.assert_array_equal(got["schunk_pst"], ref_sc.pst_weight)
        assert int(got["schunk_rounds"]) == ref_sc_rounds
        np.testing.assert_array_equal(got["sshard_parent"], ref_ss.parent)
        np.testing.assert_array_equal(got["sshard_pst"], ref_ss.pst_weight)
        assert int(got["sshard_rounds"]) == ref_ss_rounds


PORT_G2T = ("import sys\n"
            "from sheep_tpu_torch.cli.graph2tree import main\n"
            "sys.exit(main(sys.argv[1:], device='cpu'))\n")


def test_graph2tree_two_processes(tmp_path):
    """`graph2tree -i -r` as two processes joined by SHEEP_COORDINATOR,
    each in a directory of its own: only process 0 prints phase lines
    and writes, and its tree equals the reference's single-process mesh
    of two, byte for byte."""
    ref_env = env_for({"JAX_PLATFORMS": "cpu", "SHEEP_WORKERS": "2",
                       "XLA_FLAGS":
                       "--xla_force_host_platform_device_count=2"})
    dirs = [tmp_path / name for name in ("ref", "rank0", "rank1")]
    for d in dirs:
        d.mkdir()
    coord = free_coordinator()
    argv = [HEP, "-i", "-r", "-f", "-s", "S.seq", "-o", "T.tre"]
    cmds = [[sys.executable, "-m", "sheep_tpu.cli.graph2tree", *argv]]
    envs = [ref_env]
    for pid in range(2):
        cmds.append([sys.executable, "-c", PORT_G2T, *argv])
        envs.append(env_for({"SHEEP_COORDINATOR": coord,
                             "SHEEP_NUM_PROCESSES": "2",
                             "SHEEP_PROCESS_ID": str(pid)}))
    (rrc, rout, rerr), *ports = run_all(cmds, envs, dirs)
    assert rrc == 0, rout + rerr
    for rc, out, err in ports:
        assert rc == 0, out + err
    assert "Mapped in:" in ports[0][1] and "Mapped in:" not in ports[1][1]
    assert "TREEFAQS" in ports[0][1] and ports[1][1] == ""
    faqs = [ln for ln in rout.splitlines() if "TREEFAQS" in ln]
    assert faqs and faqs == [ln for ln in ports[0][1].splitlines()
                             if "TREEFAQS" in ln]
    assert sorted(os.listdir(dirs[1])) == sorted(os.listdir(dirs[0]))
    for name in os.listdir(dirs[0]):
        assert (dirs[1] / name).read_bytes() == \
            (dirs[0] / name).read_bytes(), name
    assert os.listdir(dirs[2]) == []


def test_init_distributed_unreachable_coordinator_times_out(tmp_path):
    """An unreachable coordinator fails fast with a RuntimeError naming
    the address, within SHEEP_CONNECT_TIMEOUT, instead of hanging."""
    prog = ("import sys\n"
            "from sheep_tpu_torch.parallel import init_distributed\n"
            "try:\n"
            "    init_distributed('127.0.0.1:9', 2, 1, device='cpu')\n"
            "except RuntimeError as exc:\n"
            "    print(exc)\n"
            "    sys.exit(7)\n"
            "sys.exit(0)\n")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                          text=True, timeout=120,
                          env=env_for({"SHEEP_CONNECT_TIMEOUT": "2"}))
    assert proc.returncode == 7, proc.stdout + proc.stderr
    assert "could not join" in proc.stdout
    assert "127.0.0.1:9" in proc.stdout
    assert time.monotonic() - t0 < 100
