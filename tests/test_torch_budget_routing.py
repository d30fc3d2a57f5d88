"""The host routes load no torch, so a memory budget routes the port's
``graph2tree`` as it routes the reference's.

``SHEEP_MEM_BUDGET`` prices the headroom as the budget less the process's
live RSS (``resources.governor.ResourceGovernor.mem_headroom``).  The
reference's CLI never loads jax on its host routes; the port's used to
load torch at import, most of a small budget in RSS, so the same file
and budget took another route: under 160M or 200M, ``graph2tree
data/hep-th.dat -f`` built in RAM through the reference and refused
through the port (ROADMAP.md §3, fault 3).  Each tool here runs as a
process of its own, as a user runs it, through a wrapper that reports at
exit whether torch was loaded.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")
MARK = "torch-loaded:"

#: runs ``python -m <module> args...`` and reports torch at exit, however
#: the tool ended
WRAPPER = ("import runpy, sys\n"
           "mod = sys.argv.pop(1)\n"
           "sys.argv[0] = mod\n"
           "try:\n"
           "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
           "finally:\n"
           f"    sys.stderr.write('\\n{MARK} %s\\n' % ('torch' in "
           "sys.modules))\n")


def run_tool(package: str, tool: str, argv: list, cwd: str,
             env: dict | None = None):
    """(exit code, stdout, stderr less the marker, torch loaded)."""
    full = dict(os.environ)
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    full["JAX_PLATFORMS"] = "cpu"
    for k in [k for k in full if k.startswith("SHEEP_")]:
        del full[k]
    full.update(env or {})
    proc = subprocess.run(
        [sys.executable, "-c", WRAPPER, f"{package}.cli.{tool}", *argv],
        capture_output=True, text=True, timeout=300, env=full, cwd=cwd)
    marks = re.findall(rf"^{MARK} (True|False)$", proc.stderr, re.M)
    assert len(marks) == 1, proc.stderr
    err = proc.stderr.replace(f"\n{MARK} {marks[0]}\n", "")
    return proc.returncode, proc.stdout, err, marks[0] == "True"


def masked(out: str) -> list:
    """stdout with the phase times masked."""
    return [re.sub(r" in: [0-9.]+( seconds|ms)", r" in: T\1", ln)
            for ln in out.splitlines()]


def warnings_of(err: str) -> list:
    return [ln for ln in err.splitlines() if ln.startswith("warning:")]


@pytest.mark.parametrize("budget", ["160M", "200M", "260M"])
def test_budget_routes_like_the_reference(tmp_path, budget):
    """The fault's input: under each budget the port exits with the
    reference's code, prints its stdout (phase times masked) and its
    stderr warnings, and never loads torch."""
    env = {"SHEEP_MEM_BUDGET": budget}
    got = {}
    for package in ("sheep_tpu", "sheep_tpu_torch"):
        d = tmp_path / package
        d.mkdir()
        got[package] = run_tool(package, "graph2tree", [HEP, "-f"], str(d),
                                env)
    rc, out, err, _ = got["sheep_tpu"]
    prc, pout, perr, torch_loaded = got["sheep_tpu_torch"]
    assert prc == rc == 0, (perr, err)
    assert masked(pout) == masked(out)
    assert warnings_of(perr) == warnings_of(err)
    assert "TREEFAQS: width:24\troots:581" in pout
    assert not torch_loaded


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """hep-th's sequence and tree, and two partial trees, made by the
    port's tools in process."""
    from sheep_tpu_torch.cli import degree_sequence, graph2tree
    d = tmp_path_factory.mktemp("hep")
    old = os.getcwd()
    os.chdir(d)
    try:
        assert degree_sequence.main([HEP, "s.seq"]) == 0
        assert graph2tree.main([HEP, "-s", "s.seq", "-o", "t.tre"]) == 0
        for k in (1, 2):
            assert graph2tree.main([HEP, "-l", f"{k}/2", "-s", "s.seq",
                                    "-o", f"p{k}.tre"]) == 0
    finally:
        os.chdir(old)
    return str(d)


#: id -> (tool, argv, env, whether the route loads torch)
ROUTES = {
    "serial": ("graph2tree", [HEP, "-f", "-c"], {}, False),
    "partial_load": ("graph2tree", [HEP, "-l", "1/2", "-f"], {}, False),
    "partition": ("graph2tree", [HEP, "-p", "2"], {}, False),
    "seq_given": ("graph2tree", [HEP, "-s", "{d}/s.seq", "-o", "t.tre"],
                  {}, False),
    "ext": ("graph2tree", [HEP, "--ext", "-f", "-o", "t.tre"], {}, False),
    "ext_env": ("graph2tree", [HEP, "-o", "t.tre"],
                {"SHEEP_EXT_BLOCK": "4096"}, False),
    "ext_checkpoint": ("graph2tree", [HEP, "--ext", "--checkpoint-dir",
                                      "ck", "-o", "t.tre"], {}, False),
    "jxn": ("graph2tree", [HEP, "-k", "-e", "-j", "-f", "-c"], {}, False),
    "jxn_width": ("graph2tree", [HEP, "-w", "8", "-x", "-f"], {}, False),
    "degree_sequence": ("degree_sequence", [HEP, "x.seq"], {}, False),
    "partition_tree": ("partition_tree", ["-f", "-g", HEP, "{d}/s.seq",
                                          "{d}/t.tre", "2"], {}, False),
    "merge_trees": ("merge_trees", ["{d}/p1.tre", "{d}/p2.tre", "-o",
                                    "m.tre", "-f"], {}, False),
    "fsck": ("fsck", ["{d}"], {}, False),
    "make_graph": ("make_graph", ["9", "4", "g.dat", "2"], {}, False),
    "plan": ("plan", ["--explain", HEP],
             {"SHEEP_MEM_BUDGET": "1G"}, False),
    "plan_hypothetical": ("plan", ["--json", "-n", "4096"], {}, False),
    # the tournament supervisor and the distributed out-of-core build
    # (their legs are tests/test_torch_supervisor.py's and
    # tests/test_torch_distext.py's)
    "supervise": ("supervise", [HEP, "-w", "2", "-d", "st", "-o", "t.tre"],
                  {}, False),
    "distext": ("graph2tree", [HEP, "--distext", "-o", "t.tre"],
                {"SHEEP_DISTEXT_LEGS": "2"}, False),
    "distext_leg": ("distext", ["hist", HEP, "-r", "0:5000", "-o",
                                "x.hist"], {}, False),
    # the routes that reach the card load torch, as before
    "mesh": ("graph2tree", [HEP, "-i", "-r", "-f"], {}, True),
    "checkpoint_serial": ("graph2tree", [HEP, "--checkpoint-dir", "ck"],
                          {}, True),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_host_routes_never_load_torch(tmp_path, artifacts, case):
    tool, argv, env, loads = ROUTES[case]
    argv = [a.format(d=artifacts) for a in argv]
    rc, out, err, torch_loaded = run_tool("sheep_tpu_torch", tool, argv,
                                          str(tmp_path), env)
    assert torch_loaded == loads, (case, err)
    if not loads:
        assert rc == 0, err
    else:
        # on a machine without CUDA the card routes refuse after loading
        # torch; with a card they build
        import torch
        assert (rc == 0) == torch.cuda.is_available(), err
