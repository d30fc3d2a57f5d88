"""The port's fault-tolerant build (sheep_tpu_torch.runtime) against the
reference's (sheep_tpu.runtime), mirroring tests/test_runtime.py.

The same seeded inputs (R-MAT 2^9 with 4 records a vertex, seed 11, as
there) go through both builds with the same RuntimeConfig and the same
FaultPlan installed in each package's injector; the forests (parent and
pst, arrays whole), the event sequences and ECV(down) (computed with
sheep_tpu.partition) must be equal, and both equal the host oracle.  The
port's build runs on the CPU here (``device="cpu"``); its reduce loop
dispatches no pipelined chunks under a runtime, and neither does the
reference's, so boundaries and events line up one for one.

The mesh rung runs on eight CPU workers (``parallel.mesh.mesh_devices``
patched, the ``mesh8`` fixture), as the reference's runs on its
8-device virtual CPU mesh: ``test_ladder_degrades_mesh_to_single``,
``test_ladder_forced_mesh_to_host_matches`` and a kill at each of the
mesh rung's boundaries, resumed, equal the reference's events and
forest.  ``test_ladder_respects_device_count`` becomes the check that on
one CPU device the default ladder leaves ``mesh`` and ``ext`` out.

Not mirrored, and why:
- ``test_init_distributed_unreachable_coordinator_times_out`` is in
  tests/test_torch_distributed.py, ``test_graph2tree_checkpoint_flags``
  (the CLI) in tests/test_torch_cli.py;
- ``test_tree_and_sequence_writers_are_atomic``: the port has no .tre or
  .seq writer yet.  The atomic writer itself is held in
  tests/test_torch_host_layers.py.
"""

import os
import time

import numpy as np
import pytest
import torch

import sheep_tpu.runtime as ref_rt
import sheep_tpu_torch.runtime as rt
from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence
from sheep_tpu.runtime import snapshot as ref_snapshot
from sheep_tpu.utils.synth import rmat_edges
from sheep_tpu_torch.ops import forest as port_forest
from sheep_tpu_torch.resources.errors import (DiskExhausted,
                                              MemoryBudgetExceeded)
from sheep_tpu_torch.runtime import (BuildKilled, DeadlineExceeded,
                                     DeviceHung, FaultPlan,
                                     InjectedDispatchFault,
                                     RetryBudgetExhausted, RetryPolicy,
                                     RuntimeConfig, clear_plan,
                                     degradable, install_plan,
                                     is_retryable, run_with_retry)
from sheep_tpu_torch.runtime import faults as port_faults
from sheep_tpu_torch.runtime import retry as port_retry
from sheep_tpu_torch.runtime import snapshot as port_snapshot

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _clean_faults():
    for mod in (ref_rt, rt):
        mod.clear_plan()
        mod.reset_counters()
    yield
    for mod in (ref_rt, rt):
        mod.clear_plan()
        mod.reset_counters()


@pytest.fixture(scope="module")
def small_graph():
    tail, head = rmat_edges(9, 4 << 9, seed=11)
    seq = degree_sequence(tail, head)
    want = build_forest(tail, head, seq)
    return tail, head, seq, want


def _assert_matches(forest, want):
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)


def _ecv_down(tail, head, seq, forest, parts=2):
    from sheep_tpu.partition.evaluate import evaluate_partition
    from sheep_tpu.partition.partition import Partition

    p = Partition.from_forest(seq, forest, parts)
    rep = evaluate_partition(p.parts, tail, head, seq, p.num_parts)
    return rep.ecv_down


def _build(side, tail, head, d=None, plan=None, **kw):
    """One resilient build on ``side`` ("ref" or "port"), with ``plan``
    (site, at, kind, times) installed in that package's injector.
    Returns (seq, forest, config); a BuildKilled propagates."""
    mod = ref_rt if side == "ref" else rt
    kw.setdefault("backoff_base_s", 0.0)
    cfg = mod.RuntimeConfig(checkpoint_dir=d, **kw)
    if plan is not None:
        mod.install_plan(mod.FaultPlan(*plan))
    try:
        if side == "ref":
            seq, forest = mod.build_graph_resilient(tail, head, config=cfg)
        else:
            seq, forest = mod.build_graph_resilient(tail, head, config=cfg,
                                                    device="cpu")
    finally:
        mod.clear_plan()
    return seq, forest, cfg


def _both(tmp_path, tail, head, name, plan=None, **kw):
    """The same build on both sides, each with its own checkpoint dir
    (None when ``name`` is None).  Returns {side: (seq, forest, cfg)}."""
    out = {}
    for side in ("ref", "port"):
        d = None if name is None else str(tmp_path / f"{name}-{side}")
        out[side] = _build(side, tail, head, d, plan, **kw)
    return out


def _assert_parity(got, want_seq, want):
    (rseq, rforest, rcfg), (pseq, pforest, pcfg) = got["ref"], got["port"]
    np.testing.assert_array_equal(pseq, want_seq)
    np.testing.assert_array_equal(pseq, rseq)
    _assert_matches(pforest, want)
    _assert_matches(pforest, rforest)
    assert pcfg.events == rcfg.events


# ---------------------------------------------------------------------------
# unit: fault injection, the classifier, retry policy
# ---------------------------------------------------------------------------


def test_fault_plan_matching_and_counters():
    install_plan(FaultPlan(site="chunk", at=2, kind="xla", times=2))
    port_faults.fault_point("chunk")          # 0
    port_faults.fault_point("mesh_chunk")     # other site unaffected
    port_faults.fault_point("chunk")          # 1
    for _ in range(2):                        # 2, 3 fault
        with pytest.raises(InjectedDispatchFault):
            port_faults.fault_point("chunk")
    port_faults.fault_point("chunk")          # 4 clean again
    assert port_faults.fault_count("chunk") == 5
    assert port_faults.fault_count("mesh_chunk") == 1


@pytest.mark.parametrize("spec", ["boundary:3:kill", "chunk:0:xla:-1",
                                  "chunk:2:deadline:3", "chunk",
                                  "chunk:1:nuke"])
def test_fault_plan_env_parse_equals_reference(spec):
    try:
        want = ref_rt.faults.parse_plan(spec)
    except ValueError:
        with pytest.raises(ValueError):
            port_faults.parse_plan(spec)
        return
    got = port_faults.parse_plan(spec)
    assert (got.site, got.at, got.kind, got.times) == \
        (want.site, want.at, want.kind, want.times)


def test_fault_plan_from_env(monkeypatch, small_graph):
    """SHEEP_FAULT_INJECT drives the port's build as it drives the
    reference's: the same events, the same forest."""
    tail, head, want_seq, want = small_graph
    monkeypatch.setenv("SHEEP_FAULT_INJECT", "chunk:1:xla:2")
    got = {side: _build(side, tail, head, ladder=("single", "host"))
           for side in ("ref", "port")}
    _assert_parity(got, want_seq, want)
    assert any(e[0] == "retry" for e in got["port"][2].events)


def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1024.00 GiB")


@pytest.mark.parametrize("exc, retryable", [
    (_oom(), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("CUDA driver error: unknown error"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (InjectedDispatchFault("x"), True),
    (DeadlineExceeded("x"), True),
    (DeviceHung("x"), True),
    (ValueError("CUDA error: not a RuntimeError"), False),
    (RuntimeError("index out of range"), False),
    (RuntimeError("an error: CUDA error: not at the start"), False),
    (TypeError("bad"), False),
    (BuildKilled("x"), False),
    (RetryBudgetExhausted("x"), False),
    # K1's own launch failure is not a CUDA fault to retry: it propagates
    (RuntimeError("fused_jump kernel launch failed: CUDA error 700"), False),
])
def test_classifier(exc, retryable):
    assert is_retryable(exc) is retryable


def _exhausted(cause):
    try:
        raise RetryBudgetExhausted("spent") from cause
    except RetryBudgetExhausted as exc:
        return exc


@pytest.mark.parametrize("exc, degrades", [
    (_oom(), True),
    (MemoryError(), True),
    (MemoryBudgetExceeded("x"), True),
    (InjectedDispatchFault("x"), True),
    (DeadlineExceeded("x"), True),
    (DeviceHung("x"), True),
    (RetryBudgetExhausted("no cause"), True),
    (_exhausted(_oom()), True),
    (_exhausted(DeviceHung("x")), True),
    (_exhausted(InjectedDispatchFault("x")), True),
    # a kernel fault on the card is retried, then fails the build
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (_exhausted(RuntimeError("CUDA error: an illegal memory access was "
                             "encountered")), False),
    (_exhausted(RuntimeError("CUDA driver error: unknown error")), False),
    (DiskExhausted("x"), False),
    (ValueError("x"), False),
    (BuildKilled("x"), False),
])
def test_degradable(exc, degrades):
    assert degradable(exc) is degrades


def test_classifier_takes_accelerator_error():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    try:
        exc = accel("CUDA error: an illegal memory access was encountered")
    except TypeError:
        pytest.skip("torch.AcceleratorError cannot be built by hand here")
    assert is_retryable(exc)
    assert not degradable(exc)


def test_run_with_retry_shrinks_and_backs_off():
    sleeps = []
    policy = RetryPolicy(max_retries=3, backoff_base_s=0.1,
                         sleep=sleeps.append)
    install_plan(FaultPlan(site="s", at=0, kind="xla", times=2))
    out, j = run_with_retry(policy, "s",
                            lambda jj: torch.tensor(jj, dtype=torch.int32), 8)
    assert j == 2  # 8 -> 4 -> 2 across two faulted attempts
    assert int(out) == 2
    assert sleeps == [0.1, 0.2]  # exponential


def test_run_with_retry_budget_exhausted():
    policy = RetryPolicy(max_retries=2, backoff_base_s=0.0,
                         sleep=lambda s: None)
    install_plan(FaultPlan(site="s", at=0, kind="xla", times=-1))
    with pytest.raises(RetryBudgetExhausted):
        run_with_retry(policy, "s", lambda jj: jj, 8)


@pytest.mark.parametrize("kind", ["kill", "programming_error"])
def test_run_with_retry_never_retries_kill_or_bugs(kind):
    calls = []
    policy = RetryPolicy(max_retries=5, backoff_base_s=0.0,
                         sleep=lambda s: None)

    def dispatch(jj):
        calls.append(jj)
        raise ValueError("a bug, not a fault")

    if kind == "kill":
        install_plan(FaultPlan(site="s", at=0, kind="kill"))
        with pytest.raises(BuildKilled):
            run_with_retry(policy, "s", lambda jj: jj, 8)
    else:
        with pytest.raises(ValueError):
            run_with_retry(policy, "s", dispatch, 8)
        assert calls == [8]  # one attempt, no retry


def test_run_with_retry_retries_a_real_oom_until_exhausted():
    calls = []
    policy = RetryPolicy(max_retries=2, backoff_base_s=0.0,
                         sleep=lambda s: None)

    def dispatch(jj):
        calls.append(jj)
        raise _oom()

    with pytest.raises(RetryBudgetExhausted, match="OutOfMemoryError"):
        run_with_retry(policy, "s", dispatch, 8)
    assert calls == [8, 4, 2]


def test_watchdog_times_out_hung_dispatch():
    hung = {"n": 0}

    def dispatch(jj):
        hung["n"] += 1
        if hung["n"] == 1:
            time.sleep(2.0)  # first attempt hangs past the watchdog
        return torch.tensor(jj, dtype=torch.int32)

    policy = RetryPolicy(max_retries=2, backoff_base_s=0.0,
                         watchdog_s=0.2, sleep=lambda s: None)
    out, j = run_with_retry(policy, "s", dispatch, 8)
    assert hung["n"] == 2 and j == 4  # retried once, shrunk
    assert int(out) == 4


def test_watchdog_on_queued_cuda_work_gives_the_rung_up(monkeypatch):
    """A timeout whose outputs already sit on a CUDA stream is DeviceHung,
    and the retry wrapper spends the budget at once: no retry would run
    ahead of the hung work on that stream.  (On the CPU the outputs'
    "queued on CUDA" is faked; tests/test_torch_cuda.py holds the real
    case.)"""
    monkeypatch.setattr(port_retry, "_cuda_tensors", lambda out: [out])
    monkeypatch.setattr(port_retry, "sync_outputs",
                        lambda out: time.sleep(2.0))
    calls = []

    def dispatch(jj):
        calls.append(jj)
        return jj

    policy = RetryPolicy(max_retries=3, backoff_base_s=0.0,
                         watchdog_s=0.2, sleep=lambda s: None)
    with pytest.raises(RetryBudgetExhausted, match="DeviceHung"):
        run_with_retry(policy, "s", dispatch, 8)
    assert calls == [8]


def test_sync_outputs_waits_for_nothing_on_the_cpu():
    out = (torch.zeros(3), [torch.ones(2)], {"a": torch.zeros(1)})
    assert port_retry.sync_outputs(out) is False
    assert port_retry._cuda_tensors(out) == []
    if not torch.cuda.is_initialized():
        assert port_retry._caller_stream() is None


# ---------------------------------------------------------------------------
# resilient builds equal the reference's and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ladder", [("single", "host"), ("host",),
                                    ("stream",), ("spill",)])
@pytest.mark.parametrize("ckpt", [False, True])
def test_resilient_build_matches_reference(small_graph, tmp_path, ladder,
                                           ckpt):
    tail, head, want_seq, want = small_graph
    got = _both(tmp_path, tail, head, "ck" if ckpt else None, ladder=ladder)
    _assert_parity(got, want_seq, want)
    kinds = {e[0] for e in got["port"][2].events}
    assert ("checkpoint" in kinds) is ckpt
    assert "degrade" not in kinds


def test_default_ladder_leaves_out_mesh_and_ext(small_graph, tmp_path):
    """The reference's default ladder tuple stays; on one device the
    build starts at ``single`` and never degrades.  Without an
    ``edges_path`` the ladder leaves ext out, as the reference's does;
    with a whole-input ``.dat`` it goes in between stream and spill."""
    from sheep_tpu.io.edges import write_dat
    from sheep_tpu_torch.runtime.driver import _ladder_rungs
    tail, head, _, want = small_graph
    cfg = RuntimeConfig()
    assert cfg.ladder == ref_rt.RuntimeConfig().ladder
    _, forest = rt.build_graph_resilient(tail, head, num_workers=1,
                                         config=cfg, device="cpu")
    _assert_matches(forest, want)
    assert not any(e[0] == "degrade" for e in cfg.events)
    cpu = torch.device("cpu")
    assert _ladder_rungs(cfg, None, cpu) == \
        ["single", "host", "stream", "spill"]
    path = str(tmp_path / "g.dat")
    write_dat(path, tail, head)
    with_file = RuntimeConfig(edges_path=path)
    assert _ladder_rungs(with_file, None, cpu) == \
        ["single", "host", "stream", "ext", "spill"]
    net = RuntimeConfig(edges_path=str(tmp_path / "g.net"))
    assert "ext" not in _ladder_rungs(net, None, cpu)
    _, forest = rt.build_graph_resilient(tail, head, num_workers=1,
                                         config=with_file, device="cpu")
    _assert_matches(forest, want)
    assert not any(e[0] in ("degrade", "ext-block")
                   for e in with_file.events)


@pytest.mark.parametrize("case", [
    # (fault plan, extra config): the reference's test_runtime cases
    ("retry", ("chunk", 1, "xla", 2), {}),
    ("deadline", ("chunk", 2, "deadline", 1), {}),
    ("degrade", ("chunk", 0, "xla", -1), {"max_retries": 1}),
    ("degrade_late", ("chunk", 3, "xla", -1), {"max_retries": 2}),
    ("promote", None, {"promote_after": 2}),
    ("no_promote", None, {"promote_after": 0}),
    ("demote", ("chunk", 3, "xla", 1), {"promote_after": 1}),
], ids=lambda c: c[0])
def test_fault_plans_match_reference(small_graph, tmp_path, case):
    tail, head, want_seq, want = small_graph
    _, plan, extra = case
    got = _both(tmp_path, tail, head, "ck", plan,
                ladder=("single", "host"), **extra)
    _assert_parity(got, want_seq, want)
    kinds = [e[0] for e in got["port"][2].events]
    name = case[0]
    if name in ("retry", "deadline"):
        assert "retry" in kinds and "degrade" not in kinds
    if name.startswith("degrade"):
        degrades = [(e[1], e[2]) for e in got["port"][2].events
                    if e[0] == "degrade"]
        assert degrades == [("single", "host")]
    if name == "promote":
        assert "promote" in kinds
    if name == "no_promote":
        assert "promote" not in kinds
    if name == "demote":
        assert "promote" in kinds and "demote" in kinds


def test_forced_degrade_matches_reference_and_ecv(small_graph, tmp_path):
    tail, head, want_seq, want = small_graph
    got = _both(tmp_path, tail, head, "ck", ("chunk", 0, "xla", -1),
                ladder=("single", "host", "stream"), max_retries=1)
    _assert_parity(got, want_seq, want)
    seq, forest, _ = got["port"]
    assert _ecv_down(tail, head, seq, forest) == \
        _ecv_down(tail, head, want_seq, want)


def test_pipeline_knob_does_not_pipeline_a_checkpointed_loop(
        small_graph, tmp_path, monkeypatch):
    """SHEEP_PIPELINE_CHUNKS=1 pipelines the bare loop, but a runtime's
    boundaries need settled state: the events stay the reference's."""
    tail, head, want_seq, want = small_graph
    monkeypatch.setenv("SHEEP_PIPELINE_CHUNKS", "1")
    got = _both(tmp_path, tail, head, "ck", ladder=("single", "host"))
    _assert_parity(got, want_seq, want)


def test_real_oom_in_a_dispatch_degrades(small_graph, tmp_path, monkeypatch):
    """A dispatch that raises torch.cuda.OutOfMemoryError is retried (with
    shrink), exhausts its budget and degrades; the host rung finishes on
    the host links, equal to the oracle."""
    tail, head, _, want = small_graph
    real = port_forest.fixpoint_chunk

    def oom_chunk(lo, hi, n, levels, jrounds):
        raise _oom()

    monkeypatch.setattr(port_forest, "fixpoint_chunk", oom_chunk)
    seen = []
    host = rt.driver._RUNGS["host"]

    def host_rung(lo, hi, n, r, w):
        seen.append((type(lo), type(hi)))
        return host(lo, hi, n, r, w)

    monkeypatch.setitem(rt.driver._RUNGS, "host", host_rung)
    _, forest, cfg = _build("port", tail, head, str(tmp_path),
                            ladder=("single", "host"), max_retries=2)
    monkeypatch.setattr(port_forest, "fixpoint_chunk", real)
    _assert_matches(forest, want)
    # the first sorted chunk runs one round (j = 1), so shrinking holds 1
    retries = [e for e in cfg.events if e[0] == "retry"]
    assert [e[3] for e in retries] == [1, 1]
    degrades = [e for e in cfg.events if e[0] == "degrade"]
    assert len(degrades) == 1 and "OutOfMemoryError" in degrades[0][3]
    assert seen == [(np.ndarray, np.ndarray)]


def test_a_kernel_fault_is_retried_then_fails_the_build(small_graph,
                                                       monkeypatch):
    """A dispatch that raises the CUDA runtime's error (as an illegal
    address surfaces) is retried, and once its budget is spent the build
    fails: the host rung never finishes work that was on the card."""
    tail, head, _, _ = small_graph

    def faulted(lo, hi, n, levels, jrounds):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(port_forest, "fixpoint_chunk", faulted)
    cfg = RuntimeConfig(ladder=("single", "host"), backoff_base_s=0.0,
                        max_retries=2)
    with pytest.raises(RetryBudgetExhausted, match="illegal memory access"):
        rt.build_graph_resilient(tail, head, config=cfg, device="cpu")
    kinds = [e[0] for e in cfg.events]
    assert kinds.count("retry") == 2 and "degrade" not in kinds


def test_a_programming_error_propagates(small_graph, monkeypatch):
    tail, head, _, _ = small_graph

    def broken(lo, hi, n, levels, jrounds):
        raise ValueError("a bug")

    monkeypatch.setattr(port_forest, "fixpoint_chunk", broken)
    cfg = RuntimeConfig(ladder=("single", "host"), backoff_base_s=0.0)
    with pytest.raises(ValueError, match="a bug"):
        rt.build_graph_resilient(tail, head, config=cfg, device="cpu")
    assert not any(e[0] in ("retry", "degrade") for e in cfg.events)


@pytest.fixture
def mesh8(monkeypatch):
    """The port's mesh on eight CPU workers, as the reference's tests
    force eight virtual devices."""
    from sheep_tpu_torch.parallel import mesh as port_mesh
    cpu = torch.device("cpu")
    monkeypatch.setattr(port_mesh, "mesh_devices", lambda device: [cpu] * 8)


def test_ladder_runs_the_mesh_rung_first(small_graph, tmp_path, mesh8):
    """Unfaulted on eight workers: the mesh rung builds the tree, with the
    reference's checkpoints, and nothing degrades."""
    from sheep_tpu_torch.runtime.driver import _ladder_rungs
    tail, head, want_seq, want = small_graph
    assert _ladder_rungs(RuntimeConfig(), None, torch.device("cpu"))[0] \
        == "mesh"
    got = _both(tmp_path, tail, head, "ck", ladder=("mesh", "single",
                                                    "host"))
    _assert_parity(got, want_seq, want)
    events = got["port"][2].events
    assert ("checkpoint", "mesh", 1) in events
    assert not any(e[0] == "degrade" for e in events)


def test_ladder_degrades_mesh_to_single(small_graph, tmp_path, mesh8):
    tail, head, want_seq, want = small_graph
    got = _both(tmp_path, tail, head, "ck", ("mesh_chunk", 0, "xla", -1),
                max_retries=1, ladder=("mesh", "single", "host"))
    _assert_parity(got, want_seq, want)
    degrades = [(e[1], e[2]) for e in got["port"][2].events
                if e[0] == "degrade"]
    assert degrades == [("mesh", "single")]


def test_ladder_forced_mesh_to_host_matches(small_graph, tmp_path, mesh8):
    """A forced mesh -> single -> host degradation matches the
    uninterrupted build (parent, pst and ECV(down)) and the reference."""
    tail, head, want_seq, want = small_graph
    got = _both(tmp_path, tail, head, "ck",
                ("mesh_chunk,chunk", 0, "xla", -1), max_retries=1,
                ladder=("mesh", "single", "host"))
    _assert_parity(got, want_seq, want)
    seq, forest, cfg = got["port"]
    degrades = [(e[1], e[2]) for e in cfg.events if e[0] == "degrade"]
    assert degrades == [("mesh", "single"), ("single", "host")]
    assert _ecv_down(tail, head, seq, forest) == \
        _ecv_down(tail, head, want_seq, want)


def test_mesh_rung_kill_and_resume(small_graph, tmp_path, mesh8):
    """Kill both builds at each boundary of the mesh rung in turn: each
    resume restarts at the mesh rung from its checkpoint, with the
    reference's events, and equals the oracle."""
    tail, head, want_seq, want = small_graph
    ladder = ("mesh", "single", "host")
    base = _both(tmp_path, tail, head, "base", ladder=ladder)
    _assert_parity(base, want_seq, want)
    boundaries = [e for e in base["port"][2].events if e[0] == "checkpoint"]
    assert len(boundaries) >= 2
    for k in range(len(boundaries)):
        got = {}
        for side in ("ref", "port"):
            d = str(tmp_path / f"kill{k}-{side}")
            with pytest.raises((BuildKilled, ref_rt.BuildKilled)):
                _build(side, tail, head, d, ("boundary", k, "kill"),
                       ladder=ladder)
            got[side] = _build(side, tail, head, d, resume=True,
                               ladder=ladder)
        _assert_parity(got, want_seq, want)
        resumes = [e for e in got["port"][2].events if e[0] == "resume"]
        assert resumes and resumes[0][1] == "mesh", k


def test_hang_on_the_mesh_rung_skips_the_card_rungs(small_graph, tmp_path,
                                                    mesh8, monkeypatch):
    """A hang on the card gives the mesh rung up, and the ladder goes on
    to the host rung: a rung that ran on the card would queue behind the
    held kernel."""
    from sheep_tpu_torch.parallel import chunked as port_chunked
    tail, head, _, want = small_graph

    def hung(*args, **kw):
        raise DeviceHung("dispatch mesh_chunk held past the watchdog")

    monkeypatch.setattr(port_chunked, "chunk_sharded", hung)
    cfg = RuntimeConfig(checkpoint_dir=str(tmp_path), backoff_base_s=0.0,
                        ladder=("mesh", "single", "host"))
    _, forest = rt.build_graph_resilient(tail, head, config=cfg,
                                         device="cpu")
    _assert_matches(forest, want)
    assert [(e[1], e[2]) for e in cfg.events if e[0] == "degrade"] == \
        [("mesh", "host")]


def test_chunk_runtime_device_none_needs_cuda():
    """ChunkRuntime's device None means CUDA, as every entry point's."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.runtime.driver import ChunkRuntime
    args = (RetryPolicy(), None, [], "single", 4,
            np.arange(4, dtype=np.uint32), np.zeros(4, np.uint32), "sig")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChunkRuntime(*args)
    assert ChunkRuntime(*args, device="cpu").device == torch.device("cpu")


def test_device_none_needs_cuda(small_graph):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    tail, head, _, _ = small_graph
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.build_graph_resilient(tail, head)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.build_graph_resilient(tail, head, config=RuntimeConfig(),
                                 device="cuda")


# ---------------------------------------------------------------------------
# checkpoint/resume equivalence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ladder", [("single", "host"),
                                    ("single", "host", "stream", "spill")])
def test_resume_equivalence_kill_at_every_boundary(small_graph, tmp_path,
                                                   ladder):
    """Kill both builds at EVERY chunk boundary in turn; each resumed
    build is bit-identical (parent, pst, ECV(down)) to the uninterrupted
    one and to the reference's resume, events included."""
    tail, head, want_seq, want = small_graph
    base = _both(tmp_path, tail, head, "base", ladder=ladder)
    _assert_parity(base, want_seq, want)
    seq0, forest0, cfg0 = base["port"]
    ecv0 = _ecv_down(tail, head, seq0, forest0)
    boundaries = [e for e in cfg0.events if e[0] == "checkpoint"]
    assert len(boundaries) >= 3, \
        f"graph too small to exercise resume ({len(boundaries)} boundaries)"

    for k in range(len(boundaries)):
        got = {}
        for side in ("ref", "port"):
            d = str(tmp_path / f"kill{k}-{side}")
            with pytest.raises((BuildKilled, ref_rt.BuildKilled)):
                _build(side, tail, head, d, ("boundary", k, "kill"),
                       ladder=ladder)
            got[side] = _build(side, tail, head, d, resume=True,
                               ladder=ladder)
        _assert_parity(got, want_seq, want)
        seq1, forest1, cfg1 = got["port"]
        assert any(e[0] == "resume" for e in cfg1.events), k
        np.testing.assert_array_equal(seq1, seq0)
        _assert_matches(forest1, forest0)
        assert _ecv_down(tail, head, seq1, forest1) == ecv0, k


def test_degrade_hands_the_checkpoint_to_the_next_rung(small_graph,
                                                       tmp_path):
    """A fault past the first boundaries with no retry budget: the host
    rung picks up the single rung's last checkpoint, on both sides alike,
    and a kill on the host rung resumes there."""
    tail, head, want_seq, want = small_graph
    ladder = ("single", "host")
    got = _both(tmp_path, tail, head, "ck", ("chunk", 2, "xla", -1),
                ladder=ladder, max_retries=0)
    _assert_parity(got, want_seq, want)
    events = got["port"][2].events
    assert [e[0] for e in events].count("checkpoint") >= 2
    assert [(e[1], e[2]) for e in events if e[0] == "degrade"] == \
        [("single", "host")]


def test_resume_without_checkpoint_builds_fresh(small_graph, tmp_path):
    tail, head, _, want = small_graph
    _, forest, cfg = _build("port", tail, head, str(tmp_path), resume=True,
                            ladder=("single", "host"))
    _assert_matches(forest, want)
    assert not any(e[0] == "resume" for e in cfg.events)


def test_resume_rejects_mismatched_input(small_graph, tmp_path):
    tail, head, _, _ = small_graph
    d = str(tmp_path)
    with pytest.raises(BuildKilled):
        _build("port", tail, head, d, ("boundary", 1, "kill"),
               ladder=("single", "host"))
    other_t, other_h = rmat_edges(9, 4 << 9, seed=99)
    with pytest.raises(ValueError, match="refusing to resume"):
        _build("port", other_t, other_h, d, resume=True,
               ladder=("single", "host"))


def test_checkpoint_cleared_on_success(small_graph, tmp_path):
    tail, head, _, _ = small_graph
    _build("port", tail, head, str(tmp_path), ladder=("single", "host"))
    assert not os.path.exists(tmp_path / port_snapshot.SNAPSHOT_NAME)
    assert os.listdir(tmp_path) == []


def test_snapshot_roundtrip(tmp_path):
    seq = np.arange(8, dtype=np.uint32)
    sig = port_snapshot.input_signature(8, seq)
    ck = port_snapshot.Checkpointer(str(tmp_path), every=2)
    snap = port_snapshot.Snapshot(
        n=8, seq=seq, pst=np.ones(8, np.uint32),
        lo=np.array([0, 1], np.int32), hi=np.array([3, 7], np.int32),
        rounds=5, boundary=0, rung="single", input_sig=sig)
    assert ck.want()
    ck.save(snap)
    assert not ck.want()  # cadence: every 2nd boundary persists
    ck.skip()
    assert ck.want()
    back = port_snapshot.Checkpointer(str(tmp_path)).load()
    assert back is not None and back.rounds == 5 and back.rung == "single"
    np.testing.assert_array_equal(back.lo, snap.lo)
    back.verify(sig)
    with pytest.raises(ValueError, match="refusing to resume"):
        back.verify(port_snapshot.input_signature(8, seq[::-1].copy()))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_format_is_the_references(tmp_path, writer):
    """One checkpoint format: a snapshot either package writes, the other
    loads (sidecar verified), field for field; and both packages sign an
    input alike."""
    rng = np.random.default_rng(7)
    seq = rng.permutation(64).astype(np.uint32)
    tail = rng.integers(0, 64, 200).astype(np.uint32)
    head = rng.integers(0, 64, 200).astype(np.uint32)
    sig = port_snapshot.input_signature(64, seq, tail, head)
    assert sig == ref_snapshot.input_signature(64, seq, tail, head)
    w, r = (ref_snapshot, port_snapshot) if writer == "ref" \
        else (port_snapshot, ref_snapshot)
    lo = np.sort(rng.integers(0, 60, 50)).astype(np.int32)
    hi = (lo + rng.integers(1, 4, 50)).astype(np.int32)
    snap = w.Snapshot(n=64, seq=seq, pst=np.arange(64, dtype=np.uint32),
                      lo=lo, hi=hi, rounds=9, boundary=0, rung="host",
                      input_sig=sig)
    w.Checkpointer(str(tmp_path)).save(snap)
    back = r.load_snapshot(os.path.join(str(tmp_path), r.SNAPSHOT_NAME),
                           integrity="strict")
    for field in ("n", "rounds", "boundary", "rung", "input_sig"):
        assert getattr(back, field) == getattr(snap, field)
    for field in ("seq", "pst", "lo", "hi"):
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(snap, field))


def test_corrupt_checkpoint_strict_raises_repair_rebuilds(small_graph,
                                                          tmp_path):
    from sheep_tpu_torch.integrity.errors import IntegrityError

    tail, head, _, want = small_graph
    d = str(tmp_path)
    with pytest.raises(BuildKilled):
        _build("port", tail, head, d, ("boundary", 2, "kill"),
               ladder=("single", "host"))
    path = os.path.join(d, port_snapshot.SNAPSHOT_NAME)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IntegrityError):
        _build("port", tail, head, d, resume=True, ladder=("single", "host"),
               integrity="strict")
    _, forest, cfg = _build("port", tail, head, d, resume=True,
                            ladder=("single", "host"), integrity="repair")
    _assert_matches(forest, want)
    assert [e[0] for e in cfg.events][0] == "corrupt-checkpoint"


# ---------------------------------------------------------------------------
# checkpoint cadence auto-tuning, promotion
# ---------------------------------------------------------------------------


def test_auto_cadence_retunes_from_measurement(tmp_path):
    ck = port_snapshot.Checkpointer(str(tmp_path), every=0)
    assert ck.auto and ck.every == 1
    assert ck.observe(1.0, 1.0) == 10
    assert ck.observe(0.001, 1.0) == 1
    assert ck.observe(100.0, 0.1) == 64
    assert ck.observe(100.0, 0.1) is None  # unchanged -> no event
    assert ck.observe(1.0, 0.0) is None
    assert ck.observe(-1.0, 1.0) is None


def test_fixed_cadence_ignores_observations(tmp_path):
    ck = port_snapshot.Checkpointer(str(tmp_path), every=3)
    assert not ck.auto
    assert ck.observe(9.0, 0.1) is None
    assert ck.every == 3
    with pytest.raises(ValueError):
        port_snapshot.Checkpointer(str(tmp_path), every=-1)


@pytest.mark.parametrize("var, value, field, want", [
    ("SHEEP_CHECKPOINT_EVERY", "auto", "checkpoint_every", 0),
    ("SHEEP_CHECKPOINT_EVERY", "4", "checkpoint_every", 4),
    ("SHEEP_PROMOTE_AFTER", "0", "promote_after", 0),
    ("SHEEP_PROMOTE_AFTER", "5", "promote_after", 5),
    ("SHEEP_WATCHDOG_S", "0.5", "watchdog_s", 0.5),
    ("SHEEP_MAX_RETRIES", "7", "max_retries", 7),
    ("SHEEP_RESUME", "1", "resume", True),
    ("SHEEP_EDGES_PATH", "/data/g.dat", "edges_path", "/data/g.dat"),
    ("SHEEP_EDGES_PATH", "", "edges_path", None),
])
def test_config_from_env_equals_reference(monkeypatch, var, value, field,
                                          want):
    monkeypatch.setenv(var, value)
    got = getattr(RuntimeConfig.from_env(), field)
    assert got == want == getattr(ref_rt.RuntimeConfig.from_env(), field)


def test_auto_cadence_build_matches_reference(small_graph, tmp_path):
    tail, head, want_seq, want = small_graph
    got = _both(tmp_path, tail, head, "ck", checkpoint_every=0,
                ladder=("single", "host"))
    # the cadence retunes from measured times, which differ between the
    # two builds: the forests must agree, the checkpoint events need not
    for side in ("ref", "port"):
        _assert_matches(got[side][1], want)
    assert any(e[0] == "checkpoint" for e in got["port"][2].events)


def test_auto_cadence_resume_still_bit_identical(small_graph, tmp_path):
    tail, head, _, want = small_graph
    d = str(tmp_path)
    with pytest.raises(BuildKilled):
        _build("port", tail, head, d, ("boundary", 1, "kill"),
               checkpoint_every=0, ladder=("single", "host"))
    _, forest, _ = _build("port", tail, head, d, resume=True,
                          checkpoint_every=0, ladder=("single", "host"))
    _assert_matches(forest, want)
