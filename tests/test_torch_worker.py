"""The remote build workers (port of sheep_tpu/serve/worker.py,
supervisor/remote.py and the distext ship arm) against the reference's.

Every test of tests/test_worker.py (the workers' METRICS scrape and
``top``'s view of them among them) runs twice in one directory: as the
reference wrote it, then rebound to the port (tests/torch_twin.py),
each side with worker daemons of its own package.  The reference's
assertions hold on the port (trees equal to the oracle, exact dispatch
counts under every netfault and chaos plan), and the trees, histograms
and dispatch counts both runs leave are equal.  Two mixed cases ship a
reference supervisor's legs to port workers and the other way round."""

import contextlib
import importlib
import json
import os

import pytest

import test_worker as W
from torch_twin import (assert_same, cases, clear_fault_plans, dir_bytes,
                        port_twin, run_twin)

PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
#: what the worker fixtures' env clearing covers (tests/test_worker.py)
ENV = ("SHEEP_EXT_BLOCK", "SHEEP_EXT_STRATEGY", "SHEEP_MEM_BUDGET",
       "SHEEP_DISK_BUDGET", "SHEEP_IO_FAULT_PLAN", "SHEEP_FAULT_PLAN",
       "SHEEP_DISTEXT_LEGS", "SHEEP_LEG_CORES", "SHEEP_WORKERS",
       "SHEEP_WORKER_ADDRS", "SHEEP_WORKER_BEAT_S",
       "SHEEP_WORKER_SPECULATE_S", "SHEEP_WORKER_TRANSPORT",
       "SHEEP_SERVE_NETFAULT_PLAN", "SHEEP_SPECULATE_S")


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    clear_fault_plans()
    for pkg in PKGS.values():
        importlib.import_module(f"{pkg}.runtime").reset_counters()
    yield
    clear_fault_plans()


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """The reference fixture's graph and oracle tree bytes."""
    return W.graph.__wrapped__(tmp_path_factory)


def fixtures(graph, worker_side=None):
    """The reference module's fixtures for one side: ``worker_env``
    (the side's env and plans cleared), ``workers`` (two worker daemons
    of ``worker_side``'s package, default the side's own) and
    ``graph``."""
    @contextlib.contextmanager
    def provide(side, work, mp):
        for k in ENV:
            mp.delenv(k, raising=False)
        pkg = PKGS[worker_side or side]
        daemon = importlib.import_module(f"{pkg}.serve.worker").WorkerDaemon
        pair = [daemon(str(work / f"w{i}")).start() for i in (1, 2)]
        try:
            yield {"graph": graph, "workers": pair, "worker_env": mp}
        finally:
            for w in pair:
                w.shutdown()
    return provide


def observe(work, side):
    """The supervisor state dirs' trees and histograms, the multiset of
    leg dispatch counts and of shipped legs' (wire dispatches,
    speculations): which of two concurrent legs a network fault hits
    first is the threads' order, so the counts are held as multisets
    (the reference's own assertions pin the keyed ones it can)."""
    out = {}
    for name in sorted(os.listdir(work)):
        sup = os.path.join(work, name)
        if not name.startswith("sup") or not os.path.isdir(sup):
            continue
        out.update({f"{name}/{k}": v for k, v in dir_bytes(
            sup, suffixes=(".tre", ".hist")).items()})
        with open(os.path.join(sup, "manifest.json")) as f:
            legs = json.load(f)["legs"]
        out[f"{name}/dispatches"] = sorted(leg["dispatches"]
                                           for leg in legs)
        wires = []
        for fn in sorted(os.listdir(sup)):
            if fn.startswith("wire-"):
                with open(os.path.join(sup, fn)) as f:
                    row = json.load(f)
                wires.append((row["dispatches"], row["speculations"]))
        out[f"{name}/wire"] = sorted(wires)
    return out


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(W)],
                         ids=[c[0] for c in cases(W)])
def test_worker_twin(tmp_path, monkeypatch, graph, name, params):
    assert_same(run_twin(getattr(W, name), tmp_path, monkeypatch, observe,
                         fixtures=fixtures(graph), params=params,
                         before=clear_fault_plans))


@pytest.mark.parametrize("sup,worker", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("name", ["test_remote_build_bit_identical",
                                  "test_chaos_plan_applies_to_remote_legs"])
def test_mixed_supervisor_and_workers(tmp_path, monkeypatch, graph, name,
                                      sup, worker):
    """One package's supervisor ships its legs to the other package's
    workers, plainly and under a chaos plan (kill, corrupt, hang at a
    dispatch): the tree is the oracle's and equals a reference-only
    run's, with the same dispatch counts.  (A network fault plan is
    module state of the package that arms it, so the in-process mixed
    runs leave the worker-side sites to the twins above.)"""
    fn = getattr(W, name)
    body = fn if sup == "ref" else port_twin(fn)
    got = {}
    for key, (run, wside) in (("ref", (fn, "ref")),
                              ("mixed", (body, worker))):
        clear_fault_plans()
        work = tmp_path / key
        work.mkdir()
        with monkeypatch.context() as mp, \
                fixtures(graph, wside)(sup, work, mp) as kw:
            run(tmp_path=work, **kw)
        got[key] = observe(work, key)
    assert_same({"ref": got["ref"], "port": got["mixed"]})


def test_remote_drive_ships_legs_to_worker_processes(tmp_path):
    """``scripts/remote_drive.py`` (chip_smoke's ``remote`` phase) at a
    small size: two worker processes, ``graph2tree --distext`` shipped
    to them equal to the in-RAM tree, a torn artifact return
    re-dispatching exactly its leg, and ``--status`` listing the remote
    legs."""
    import subprocess
    import sys
    from sheep_tpu_torch.io import write_dat
    from sheep_tpu_torch.utils.synth import rmat_edges
    tail, head = rmat_edges(11, 1 << 15, seed=3)
    g = str(tmp_path / "E.dat")
    write_dat(g, tail, head)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    run = lambda *argv: subprocess.run(  # noqa: E731
        [sys.executable, "-m", *argv], capture_output=True, text=True,
        env=env, cwd=repo, timeout=600)
    ram = run("sheep_tpu_torch.cli.graph2tree", g, "-o",
              str(tmp_path / "D.tre"))
    assert ram.returncode == 0, ram.stderr
    proc = run("sheep_tpu_torch.scripts.remote_drive", "run",
               str(tmp_path / "work"), "--graph", g, "--want",
               str(tmp_path / "D.tre"), "--budget", "400M")
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("remote_record "))
    rec = json.loads(line.split(" ", 1)[1])
    assert all(rec["checks"].values()), rec["checks"]
    assert len(rec["torn"]["redispatched"]) == 1
