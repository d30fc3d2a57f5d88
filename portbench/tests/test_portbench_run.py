"""A run end to end on the CPU at a tiny size (the harness's look for a
card skipped), the result's last line, the refusals without a card or
without the program, and what a run loads and reads."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, REPO, tiny_spec
from harness import session
from harness.spec import Spec

RUN = os.path.join(BENCH, "run.py")


@pytest.mark.parametrize("cell", Spec.load(REPO).cell_names())
@pytest.mark.parametrize("trace", [False, True])
def test_cpu_run_is_correct_and_reports(tmp_path, cell, trace):
    spec = tiny_spec(tmp_path)
    result, lines = session.run_cell(spec, cell, 2**31 + 77, 0.3, trace,
                                     torch.device("cpu"), time.perf_counter())
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "check"
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in result["check"].values())
    assert lines[-len(result["check"]):] == [
        f"check {k}: {v['value']} (limit {v['limit']})"
        for k, v in result["check"].items()]
    c = spec.cell(cell)
    kind = c.per_layer if trace else c.end_to_end
    reported = set(result["metrics"])
    assert reported <= {m["name"] for m in kind}
    for m in kind:
        if m["name"] in reported:
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
        # no device on the CPU: no device metric is written
        assert "device_idle_pct" not in reported
        assert "k1_roofline_pct" not in reported
    else:
        assert {"records_per_s", "setup_s"} <= reported
        assert "breakdown" not in result
    json.dumps(result)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without CUDA the run exits non-zero and prints no result."""
    proc = _run([RUN, "--workload", "lj.build", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], REPO)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA is not available" in proc.stderr


def test_unknown_cell_no_result():
    proc = _run([RUN, "--workload", "nope", "--seed", "1", "--seconds", "1",
                 "--trace", "0"], REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_bare_benchmark_directory_fails(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ (no program)
    gives no result: without a card it stops there, with one at the
    missing program."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(["portbench/run.py", "--workload", "lj.build", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sheep_tpu_torch_like", object())
    assert "sheep_tpu" not in session.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sheep_tpu.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert session.forbidden_modules() == ["jaxlib", "sheep_tpu"]


AUDIT = r"""
import os, sys, time, json
sys.path.insert(0, {bench!r}); sys.path.insert(1, {repo!r})
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], str):
        opened.append(os.path.abspath(args[0]))
sys.addaudithook(hook)
import pathlib, torch
sys.path.insert(0, {tests!r})
from conftest import tiny_spec
from harness import session
spec = tiny_spec(pathlib.Path({tmp!r}))
res, _ = session.run_cell(spec, {cell!r}, 5, 0.2, False,
                          torch.device("cpu"), time.perf_counter())
print(json.dumps({{"correct": res["correct"],
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "opened": sorted(set(opened))}}))
"""


@pytest.mark.parametrize("cell", ["lj.build", "lj.stream"])
def test_a_run_loads_no_jax_and_reads_no_old_file(tmp_path, cell):
    """In a fresh process, a run loads no module whose top-level name is
    jax, jaxlib, flax or sheep_tpu, and opens no file of the repository
    outside portbench/, BENCHMARK.json and the program's package."""
    code = AUDIT.format(bench=BENCH, repo=REPO,
                        tests=os.path.join(BENCH, "tests"),
                        tmp=str(tmp_path), cell=cell)
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert not set(got["modules"]) & set(session.FORBIDDEN)
    allowed = (os.path.join(REPO, "portbench") + os.sep,
               os.path.join(REPO, "sheep_tpu_torch") + os.sep,
               os.path.join(REPO, "BENCHMARK.json"), str(tmp_path))
    inside = [p for p in got["opened"] if p.startswith(REPO + os.sep)]
    assert inside and all(p.startswith(allowed) for p in inside), inside


def test_the_window_keeps_each_distinct_answer_once():
    """Equal answers are kept once; one that differs in a single entry,
    or lacks an array, is kept beside them, so the check still sees it."""
    import numpy as np

    run = session.Run(cell=None, graph=None, setup_s=0.0)
    a = {"parent": np.arange(5, dtype=np.uint32),
         "pst": np.ones(5, np.uint32)}
    run.keep(a)
    run.keep({k: v.copy() for k, v in a.items()})
    assert len(run.outputs) == 1
    b = {k: v.copy() for k, v in a.items()}
    b["parent"][3] = 0xFFFFFFFF
    run.keep(b)
    run.keep({"parent": a["parent"].copy()})
    assert len(run.outputs) == 3


def test_host_lines_say_what_the_host_did():
    before = session.host_counters()
    sum(range(200000))
    after = session.host_counters()
    build = session.Build(0.0, 1.0, None, None,
                          session._host_delta(before, after))
    lines = session.host_lines([build, build])
    assert any(line.startswith("process CPU seconds per build: ")
               for line in lines)
    assert session.host_lines([session.Build(0.0, 1.0, None, None)]) == []
