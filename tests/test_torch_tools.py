"""The port's analysis tools (sheep_tpu_torch.cli.tools) against the
reference's (sheep_tpu.cli.tools): tree2dot, tree2adj, graph2adj,
vfennel, efennel and read_partition on hep-th and on seeded multigraphs.
Stdout (with the clock lines masked) and every written file's bytes must
be equal.  In process for each case, and once per tool as a process
started the way the ``util/`` shims start the reference's tools
(``python -c "import sys; from <pkg>.cli.tools import <tool>;
sys.exit(<tool>())" ...``), where the port's process must not load
torch."""

import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_multigraph

from sheep_tpu.cli import tools as ref_tools
from sheep_tpu_torch.cli import tools as port_tools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")
TOOLS = ("tree2dot", "tree2adj", "graph2adj", "vfennel", "efennel",
         "read_partition")
PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
#: the tools' clock lines: ``Loaded in: 12ms``, ``Partitioning took: 3ms``
CLOCK = re.compile(r"(in: |took: )\d+ms")


def mask(out: str) -> str:
    return CLOCK.sub(r"\1<ms>", out)


def _inputs(d, graph: str):
    """The graph (hep-th or a seeded multigraph), its tree and a 2-part
    jnid partition file, written by the port's writers."""
    from sheep_tpu_torch.core import build_forest, degree_sequence
    from sheep_tpu_torch.core.forest import Forest
    from sheep_tpu_torch.io import write_dat, write_tree
    from sheep_tpu_torch.io.edges import load_edges
    from sheep_tpu_torch.partition.tree_partition import partition_forest

    if graph == "hep":
        path = HEP
    else:
        rng = np.random.default_rng(int(graph[1:]))
        tail, head = random_multigraph(rng, n_max=90, e_max=400)
        path = os.path.join(d, "g.dat")
        write_dat(path, tail, head)
    el = load_edges(path)
    seq = degree_sequence(el.tail, el.head)
    forest = build_forest(el.tail, el.head, seq, max_vid=el.max_vid)
    tre = os.path.join(d, "t.tre")
    write_tree(tre, forest.parent, forest.pst_weight)
    part = os.path.join(d, "t.part")
    jparts = partition_forest(Forest(forest.parent, forest.pst_weight), 2)
    np.savetxt(part, jparts, fmt="%d")
    return path, tre, part


def _argv(tool, d, side, graph, tre, part):
    out = os.path.join(d, f"{side}.out")
    return {"tree2dot": [tre, out], "tree2adj": [tre, out],
            "graph2adj": [graph, out], "vfennel": [graph, "2", "3"],
            "efennel": [graph, "2", "5"],
            "read_partition": [graph, part]}[tool], out


def _in_process(module, tool, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = getattr(module, tool)(argv)
    return rc, mask(buf.getvalue())


@pytest.mark.parametrize("graph", ["hep", "s3", "s7"])
@pytest.mark.parametrize("tool", TOOLS)
def test_tool_equals_reference(tmp_path, tool, graph):
    d = str(tmp_path)
    path, tre, part = _inputs(d, graph)
    got = {}
    for side, module in (("ref", ref_tools), ("port", port_tools)):
        argv, out = _argv(tool, d, side, path, tre, part)
        rc, text = _in_process(module, tool, argv)
        data = open(out, "rb").read() if os.path.exists(out) else None
        got[side] = (rc, text, data)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0


@pytest.mark.parametrize("tool", TOOLS)
def test_usage_equals_reference(tool):
    assert _in_process(port_tools, tool, ["x"]) == \
        _in_process(ref_tools, tool, ["x"])


def _shim(side, tool, argv, cwd):
    """The tool as a process, started as a ``util/`` shim starts it; the
    port's reports whether torch was loaded."""
    pkg = PKGS[side]
    code = (f"import sys; from {pkg}.cli.tools import {tool}; rc = {tool}(); "
            f"sys.stderr.write('torch=%s' % ('torch' in sys.modules)); "
            f"sys.exit(rc)")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", code] + argv, cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    return proc.returncode, mask(proc.stdout), proc.stderr


@pytest.mark.parametrize("tool", TOOLS)
def test_shim_process_equals_reference(tmp_path, tool):
    """On hep-th as processes: equal exit codes, stdout and file bytes;
    the port's process never loads torch.  The 2-part partition is the
    golden one (ECV(down) 521, 2811 edges cut, sizes 3409/4201)."""
    d = str(tmp_path)
    path, tre, part = _inputs(d, "hep")
    got = {}
    for side in PKGS:
        argv, out = _argv(tool, d, side, path, tre, part)
        rc, text, err = _shim(side, tool, argv, d)
        data = open(out, "rb").read() if os.path.exists(out) else None
        got[side] = (rc, text, data)
        if side == "port":
            assert err.endswith("torch=False"), err
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0
    if tool == "read_partition":
        assert "ECV(down): 521" in got["port"][1]
        assert "edges cut: 2811" in got["port"][1]
    if tool == "vfennel":
        assert "ECV(down)" not in got["port"][1]


def test_read_partition_golden_hep_lines(tmp_path):
    """The partition tree_partition makes from the port's hep-th tree,
    re-read through the port's read_partition, gives the golden lines."""
    d = str(tmp_path)
    path, _, part = _inputs(d, "hep")
    rc, out = _in_process(port_tools, "read_partition", [path, part])
    assert rc == 0
    for line in ("ECV(down): 521", "edges cut: 2811"):
        assert line in out, out
