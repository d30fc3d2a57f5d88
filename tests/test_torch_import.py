"""The port (sheep_tpu_torch) stands alone: no module of it, and not
chip_smoke.py, imports jax or anything of sheep_tpu; its entry points run
on CUDA unless the caller names the CPU."""

import ast
import os
import re
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
    "sheep_tpu_torch.parallel.build", "sheep_tpu_torch.parallel.mesh",
    "sheep_tpu_torch.parallel.chunked", "sheep_tpu_torch.parallel.stream",
    "sheep_tpu_torch.supervisor",
    "sheep_tpu_torch.supervisor.heartbeat", "sheep_tpu_torch.utils.knobs",
    # the external-memory build, the treewidth mode and the planner tool
    "sheep_tpu_torch.ops.extmem", "sheep_tpu_torch.core.jxn",
    "sheep_tpu_torch.cli.plan", "sheep_tpu_torch.runtime.config",
    # the tournament supervisor and the distributed out-of-core build
    "sheep_tpu_torch.supervisor.manifest", "sheep_tpu_torch.supervisor.chaos",
    "sheep_tpu_torch.supervisor.supervise",
    "sheep_tpu_torch.supervisor.status", "sheep_tpu_torch.ops.distext",
    "sheep_tpu_torch.cli.distext", "sheep_tpu_torch.cli.supervise",
    "sheep_tpu_torch.obs.metrics",
    # the analysis tools, the trace tool and the serve store
    "sheep_tpu_torch.serve", "sheep_tpu_torch.serve.state",
    "sheep_tpu_torch.serve.reseq", "sheep_tpu_torch.serve.wal",
    "sheep_tpu_torch.serve.protocol", "sheep_tpu_torch.serve.admission",
    "sheep_tpu_torch.serve.faults", "sheep_tpu_torch.serve.netfaults",
    "sheep_tpu_torch.obs.merge", "sheep_tpu_torch.cli.tools",
    "sheep_tpu_torch.cli.trace", "sheep_tpu_torch.scripts.serve_drive",
    # the serve daemon with replication, scrub and tenants, and the
    # remote build workers
    "sheep_tpu_torch.serve.daemon", "sheep_tpu_torch.serve.replicate",
    "sheep_tpu_torch.serve.cluster", "sheep_tpu_torch.serve.scrub",
    "sheep_tpu_torch.serve.tenants", "sheep_tpu_torch.serve.worker",
    "sheep_tpu_torch.supervisor.remote", "sheep_tpu_torch.cli.serve",
    "sheep_tpu_torch.cli.worker", "sheep_tpu_torch.scripts.daemon_drive",
    "sheep_tpu_torch.scripts.remote_drive",
    # the routed fleet
    "sheep_tpu_torch.serve.router", "sheep_tpu_torch.serve.migrate",
    "sheep_tpu_torch.serve.rebalance", "sheep_tpu_torch.cli.route",
    "sheep_tpu_torch.cli.top", "sheep_tpu_torch.scripts.fleet_drive")

#: modules a host route imports: none may load torch on import
TORCH_FREE = (
    "sheep_tpu_torch", "sheep_tpu_torch.ops", "sheep_tpu_torch.ops.extmem",
    "sheep_tpu_torch.runtime", "sheep_tpu_torch.runtime.config",
    "sheep_tpu_torch.runtime.faults", "sheep_tpu_torch.runtime.retry",
    "sheep_tpu_torch.runtime.snapshot", "sheep_tpu_torch.core",
    "sheep_tpu_torch.core.jxn", "sheep_tpu_torch.native",
    "sheep_tpu_torch.io", "sheep_tpu_torch.partition",
    "sheep_tpu_torch.plan", "sheep_tpu_torch.resources",
    "sheep_tpu_torch.integrity", "sheep_tpu_torch.obs",
    "sheep_tpu_torch.cli.common", "sheep_tpu_torch.cli.graph2tree",
    "sheep_tpu_torch.cli.degree_sequence", "sheep_tpu_torch.cli.make_graph",
    "sheep_tpu_torch.cli.partition_tree", "sheep_tpu_torch.cli.merge_trees",
    "sheep_tpu_torch.cli.fsck", "sheep_tpu_torch.cli.plan",
    "sheep_tpu_torch.supervisor", "sheep_tpu_torch.supervisor.manifest",
    "sheep_tpu_torch.supervisor.chaos", "sheep_tpu_torch.supervisor.supervise",
    "sheep_tpu_torch.supervisor.status", "sheep_tpu_torch.ops.distext",
    "sheep_tpu_torch.cli.distext", "sheep_tpu_torch.cli.supervise",
    "sheep_tpu_torch.obs.metrics",
    "sheep_tpu_torch.serve", "sheep_tpu_torch.serve.state",
    "sheep_tpu_torch.serve.reseq", "sheep_tpu_torch.serve.wal",
    "sheep_tpu_torch.serve.protocol", "sheep_tpu_torch.serve.admission",
    "sheep_tpu_torch.serve.faults", "sheep_tpu_torch.serve.netfaults",
    "sheep_tpu_torch.obs.merge", "sheep_tpu_torch.cli.tools",
    "sheep_tpu_torch.cli.trace", "sheep_tpu_torch.scripts.serve_drive",
    # the serve daemon with replication, scrub and tenants, and the
    # remote build workers
    "sheep_tpu_torch.serve.daemon", "sheep_tpu_torch.serve.replicate",
    "sheep_tpu_torch.serve.cluster", "sheep_tpu_torch.serve.scrub",
    "sheep_tpu_torch.serve.tenants", "sheep_tpu_torch.serve.worker",
    "sheep_tpu_torch.supervisor.remote", "sheep_tpu_torch.cli.serve",
    "sheep_tpu_torch.cli.worker", "sheep_tpu_torch.scripts.daemon_drive",
    "sheep_tpu_torch.scripts.remote_drive",
    # the routed fleet
    "sheep_tpu_torch.serve.router", "sheep_tpu_torch.serve.migrate",
    "sheep_tpu_torch.serve.rebalance", "sheep_tpu_torch.cli.route",
    "sheep_tpu_torch.cli.top", "sheep_tpu_torch.scripts.fleet_drive")


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


def test_host_modules_load_no_torch():
    """The host layers, the CLI and the lazy packages import without
    torch; a device name resolved through them loads it on first use."""
    prog = ("import importlib, sys\n"
            f"for m in {TORCH_FREE!r}:\n"
            "    importlib.import_module(m)\n"
            "from sheep_tpu_torch.runtime import RuntimeConfig\n"
            "from sheep_tpu_torch.ops import build_forest_extmem\n"
            "from sheep_tpu_torch.ops import run_distext\n"
            "print('torch' in sys.modules)\n"
            "from sheep_tpu_torch.ops import build_graph_hybrid\n"
            "from sheep_tpu_torch.runtime import build_graph_resilient\n"
            "print('torch' in sys.modules)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"], out.stdout


def test_lazy_packages_resolve_every_name():
    import sheep_tpu_torch.ops as ops
    import sheep_tpu_torch.runtime as rt
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
    for name in rt.__all__:
        assert getattr(rt, name) is not None, name
    assert set(ops.__all__) <= set(dir(ops))
    with pytest.raises(AttributeError):
        ops.no_such_name
    with pytest.raises(AttributeError):
        rt.no_such_name


@pytest.mark.parametrize("path", [
    "sheep_tpu_torch", "chip_smoke.py",
    # the fault-tolerant build's subpackages, each on its own
    "sheep_tpu_torch/runtime", "sheep_tpu_torch/integrity",
    "sheep_tpu_torch/resources", "sheep_tpu_torch/plan",
    "sheep_tpu_torch/obs", "sheep_tpu_torch/io",
    # the CLI and what it stands on
    "sheep_tpu_torch/cli", "sheep_tpu_torch/parallel",
    "sheep_tpu_torch/supervisor", "sheep_tpu_torch/utils",
    "sheep_tpu_torch/ops",
    # the serve store, the merge of traces, the tools and the trace tool
    "sheep_tpu_torch/serve", "sheep_tpu_torch/obs/merge.py",
    "sheep_tpu_torch/cli/tools.py", "sheep_tpu_torch/cli/trace.py",
    # the serve daemon, replication, scrub, tenants, the remote workers
    "sheep_tpu_torch/serve/daemon.py", "sheep_tpu_torch/serve/replicate.py",
    "sheep_tpu_torch/serve/cluster.py", "sheep_tpu_torch/serve/scrub.py",
    "sheep_tpu_torch/serve/tenants.py", "sheep_tpu_torch/serve/worker.py",
    "sheep_tpu_torch/supervisor/remote.py", "sheep_tpu_torch/cli/serve.py",
    "sheep_tpu_torch/cli/worker.py",
    # the routed fleet
    "sheep_tpu_torch/serve/router.py", "sheep_tpu_torch/serve/migrate.py",
    "sheep_tpu_torch/serve/rebalance.py", "sheep_tpu_torch/cli/route.py",
    "sheep_tpu_torch/cli/top.py", "sheep_tpu_torch/scripts/fleet_drive.py"])
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


def _serve_package(pkg: str) -> tuple:
    """What importing ``pkg.serve`` (with ``state`` and ``reseq``, as
    ``state.py``'s ``from . import`` runs it) loads: its submodules, and
    which of the package's public names it exports."""
    prog = ("import sys\n"
            f"import {pkg}.serve as s\n"
            f"import {pkg}.serve.state, {pkg}.serve.reseq\n"
            "print(sorted(k.rsplit('.', 1)[1] for k in sys.modules\n"
            f"             if k.startswith('{pkg}.serve.')))\n"
            "print(sorted(s.__all__))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, names = out.stdout.splitlines()
    return eval(loaded), eval(names)


def test_serve_package_exports_only_ported_modules():
    """The port's ``serve/__init__.py`` loads the same submodules as the
    reference's (the router with them, and not the migration or the
    rebalancer, which the router loads when it first needs them), exports
    every name the reference's exports (the port adds ``run_reseq`` and
    ``resume_reseq``), and ``serve/`` holds the reference's files."""
    ref_loaded, ref_names = _serve_package("sheep_tpu")
    loaded, names = _serve_package("sheep_tpu_torch")
    assert loaded == ref_loaded
    assert "router" in loaded and "migrate" not in loaded
    assert set(names) - set(ref_names) == {"resume_reseq", "run_reseq"}
    assert set(ref_names) <= set(names)
    files = lambda pkg: sorted(  # noqa: E731
        f for f in os.listdir(os.path.join(REPO, pkg, "serve"))
        if f.endswith(".py"))
    assert files("sheep_tpu_torch") == files("sheep_tpu")


def test_port_has_every_reference_module_but_the_jax_shim():
    """Every module of the reference has its counterpart in the port,
    but ``utils/compat.py`` (a jax ``shard_map`` shim; the port's
    ``parallel.mesh.Mesh`` does its job) and ``ops/pallas_jump.py`` (K1's
    Pallas wrapper, whose counterpart is ``ops/fused_jump.py`` over
    ``csrc/fused_jump.cu``), and nothing in the port names a module as
    not ported."""
    def tree(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(r, f), root)
                for r, _, fs in os.walk(root) for f in fs
                if f.endswith(".py") and "__pycache__" not in r}
    assert tree("sheep_tpu") - tree("sheep_tpu_torch") == \
        {os.path.join("utils", "compat.py"),
         os.path.join("ops", "pallas_jump.py")}
    assert os.path.join("ops", "fused_jump.py") in tree("sheep_tpu_torch")
    pattern = re.compile(r"unported|QUEUE")
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                text = open(os.path.join(root, fn)).read()
                assert not pattern.search(text), fn


def test_source_names_no_reference_tool_to_run():
    """No module path of the reference's tools (``sheep_tpu.cli.<tool>``)
    appears anywhere in the port's sources, strings included: a runner
    that started one would run the reference's legs."""
    pattern = re.compile(r"sheep_tpu\.cli\.")
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                text = open(os.path.join(root, fn)).read()
                assert not pattern.search(text), fn


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
