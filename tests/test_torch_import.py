"""The port (sheep_tpu_torch) stands alone: no module of it, and not
chip_smoke.py, imports jax or anything of sheep_tpu; its entry points run
on CUDA unless the caller names the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sheep_tpu_torch")
FORBIDDEN = ("jax", "sheep_tpu")
#: the fault-tolerant build and the host layers it stands on
NEW_MODULES = (
    "sheep_tpu_torch.core.validate", "sheep_tpu_torch.integrity",
    "sheep_tpu_torch.integrity.errors", "sheep_tpu_torch.integrity.sidecar",
    "sheep_tpu_torch.io.atomic", "sheep_tpu_torch.io.faultfs",
    "sheep_tpu_torch.io.prefetch", "sheep_tpu_torch.obs",
    "sheep_tpu_torch.obs.trace", "sheep_tpu_torch.plan",
    "sheep_tpu_torch.plan.model", "sheep_tpu_torch.plan.priors",
    "sheep_tpu_torch.resources", "sheep_tpu_torch.resources.errors",
    "sheep_tpu_torch.resources.gc", "sheep_tpu_torch.resources.governor",
    "sheep_tpu_torch.runtime", "sheep_tpu_torch.runtime.driver",
    "sheep_tpu_torch.runtime.faults", "sheep_tpu_torch.runtime.retry",
    "sheep_tpu_torch.runtime.snapshot", "sheep_tpu_torch.utils.envinfo",
    # the CLI and what it stands on
    "sheep_tpu_torch.cli", "sheep_tpu_torch.cli.common",
    "sheep_tpu_torch.cli.degree_sequence", "sheep_tpu_torch.cli.fsck",
    "sheep_tpu_torch.cli.graph2tree", "sheep_tpu_torch.cli.make_graph",
    "sheep_tpu_torch.cli.merge_trees", "sheep_tpu_torch.cli.partition_tree",
    "sheep_tpu_torch.integrity.fsck", "sheep_tpu_torch.parallel",
    "sheep_tpu_torch.parallel.build", "sheep_tpu_torch.supervisor",
    "sheep_tpu_torch.supervisor.heartbeat", "sheep_tpu_torch.utils.knobs")


def _modules():
    names = []
    for root, _, files in os.walk(PKG):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, fn), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            names.append(".".join(parts))
    return sorted(names)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax_and_no_sheep_tpu():
    mods = _modules()
    for mod in ("sheep_tpu_torch.ops.build", "sheep_tpu_torch.ops.probe",
                "sheep_tpu_torch.ops.stream",
                "sheep_tpu_torch.scripts.kernel_probe") + NEW_MODULES:
        assert mod in mods
    prog = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k in ('jax', 'sheep_tpu')\n"
            "             or k.startswith(('jax.', 'sheep_tpu.')))\n"
            "print(repr(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", [
    "sheep_tpu_torch", "chip_smoke.py",
    # the fault-tolerant build's subpackages, each on its own
    "sheep_tpu_torch/runtime", "sheep_tpu_torch/integrity",
    "sheep_tpu_torch/resources", "sheep_tpu_torch/plan",
    "sheep_tpu_torch/obs", "sheep_tpu_torch/io",
    # the CLI and what it stands on
    "sheep_tpu_torch/cli", "sheep_tpu_torch/parallel",
    "sheep_tpu_torch/supervisor", "sheep_tpu_torch/utils"])
def test_source_imports_no_jax_and_no_sheep_tpu(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(r, f) for r, _, fs in os.walk(full)
        for f in fs if f.endswith(".py")]
    assert files
    for fn in files:
        tree = ast.parse(open(fn).read(), fn)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _forbidden(name), f"{fn}: imports {name}"


def test_forbidden_rule_matches_whole_module_names():
    assert _forbidden("sheep_tpu") and _forbidden("sheep_tpu.ops.forest")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("sheep_tpu_torch") and not _forbidden("jaxlib_x")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.ops.build import (build_graph_device,
                                           build_graph_hybrid)
    from sheep_tpu_torch.ops.sort import degree_sequence_device

    tail = np.array([0, 1, 2], np.uint32)
    head = np.array([1, 2, 0], np.uint32)
    for fn in (build_graph_hybrid, build_graph_device,
               degree_sequence_device):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(tail, head)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(tail, head, device="cuda")


def test_streaming_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.ops import stream

    blocks = [(np.array([0, 1], np.uint32), np.array([1, 2], np.uint32))]
    pos = np.arange(3, dtype=np.int64)
    for fn, args in ((stream.build_graph_streaming, (3, pos, 4)),
                     (stream.build_graph_streaming_hosted, (3, pos, 4)),
                     (stream.streaming_degree_histogram, (3,))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(iter(blocks), *args)


def test_resilient_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.runtime import build_graph_resilient

    tail = np.array([0, 1, 2], np.uint32)
    head = np.array([1, 2, 0], np.uint32)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_graph_resilient(tail, head, device=device)


def test_probe_tool_defaults_to_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.scripts import kernel_probe

    assert kernel_probe.main(["10"]) == 1
    assert "CUDA is not available" in capsys.readouterr().out


def test_resolve_device():
    from sheep_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)


def test_no_env_knob_picks_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    from sheep_tpu_torch.ops.build import build_graph_hybrid

    for var in ("CUDA_VISIBLE_DEVICES", "SHEEP_DEVICE", "JAX_PLATFORMS"):
        monkeypatch.setenv(var, "cpu")
    with pytest.raises(RuntimeError):
        build_graph_hybrid(np.array([0], np.uint32), np.array([1], np.uint32))
