"""The port on the card: kernels K1, P1 and P2 against their plain
versions (K1 also in forced table groupings; K1, P1 and P2 on views that
are not 16-byte aligned and on ragged lengths; K1 and P2 also with lo
below 0 and past the table), the CUDA builds (the hybrid on the
streamed, serial and speculative arms, the last also forced to hand off
the snapshot its side stream fetched) against the port's host oracle,
and the fault-tolerant build on the card (K1 on its single rung, a kill
and resume, a real CUDA out-of-memory error and a watchdog on a held
dispatch, each degrading to the host rung, and the watchdog's stream),
and ``graph2tree -i -r`` on hep-th, the user's entry point to K1.

Marked ``cuda``; each test skips without a CUDA device (the kernels are
CUDA kernels with no CPU or interpret mode).  This file imports no jax, so it
runs on the GPU machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from sheep_tpu_torch.core import build_forest, degree_sequence
from sheep_tpu_torch.ops import fused_jump as pj
from sheep_tpu_torch.ops import probe
from sheep_tpu_torch.ops.build import build_graph_device, build_graph_hybrid
from sheep_tpu_torch.ops.forest import min_up_table
from sheep_tpu_torch.utils import rmat_edges

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA kernels "
                    "with no CPU or interpret mode")
    return torch.device("cuda")


def _links(trial):
    """The draws of tests/test_pallas_jump.py (seeds 600-605)."""
    rng = np.random.default_rng(600 + trial)
    n = int(rng.integers(50, 4000))
    e = int(rng.integers(10, 20000))
    lo = rng.integers(0, n, e)
    hi = np.minimum(lo + rng.integers(1, n, e), n)
    dead = rng.random(e) < 0.2
    lo[dead] = n
    hi[dead] = n
    return n, lo.astype(np.int32), hi.astype(np.int32), \
        int(rng.integers(1, 11))


@pytest.mark.parametrize("trial", range(6))
def test_k1_launch_equals_plain(cuda, trial):
    n, lo_np, hi_np, levels = _links(trial)
    lo = torch.from_numpy(lo_np).to(cuda)
    hi = torch.from_numpy(hi_np).to(cuda)
    f = min_up_table(lo, hi, n)
    groups = pj.plan_groups(levels, n + 1, pj.l2_cache_bytes(lo.device))
    before = pj.launches
    got_lo, got_moved = pj.fused_descend(lo, hi, n, levels, f)
    torch.cuda.synchronize()
    assert pj.launches == before + len(groups)  # one launch per group
    want_lo, want_moved = pj.fused_descend_plain(lo, hi, n, levels, f)
    assert torch.equal(got_lo, want_lo)
    assert int(got_moved) == int(want_moved)


def test_k1_ragged_tail_and_empty(cuda):
    n = 1 << 16
    e = 100_003  # not a multiple of any block size
    g = torch.Generator(device=cuda).manual_seed(3)
    lo = torch.randint(0, n, (e,), generator=g, device=cuda)
    hi = torch.clamp(lo + torch.randint(1, n, (e,), generator=g,
                                        device=cuda), max=n)
    lo, hi = lo.to(torch.int32), hi.to(torch.int32)
    tables = pj.lift_tables(min_up_table(lo, hi, n), 12)
    assert torch.equal(pj.jump_group_cuda(tables, lo, hi),
                       pj.jump_group_plain(tables, lo, hi))
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    assert pj.jump_group_cuda(tables, empty, empty).numel() == 0


@pytest.mark.parametrize("layout", ["aligned", "offset1", "offset2",
                                    "offset3", "tail1", "tail2", "tail3"])
@pytest.mark.parametrize("g", [1, 2, 6])
def test_k1_forced_groups_equal_plain(cuda, g, layout):
    """A small l2_bytes forces g tables a launch; views at storage
    offsets 1-3 take the kernel's scalar path, E % 4 != 0 its tail."""
    n, levels, e = 1 << 14, 6, 50_000
    g_ = torch.Generator(device=cuda).manual_seed(11)
    base_lo = torch.randint(0, n + 1, (e + 8,), generator=g_, device=cuda)
    base_hi = torch.clamp(base_lo + torch.randint(1, n, (e + 8,),
                                                  generator=g_,
                                                  device=cuda), max=n)
    base_lo, base_hi = base_lo.to(torch.int32), base_hi.to(torch.int32)
    tables = pj.lift_tables(min_up_table(base_lo, base_hi, n), levels)
    off = int(layout[-1]) if layout.startswith("offset") else 0
    size = e + (int(layout[-1]) if layout.startswith("tail") else 0)
    lo, hi = base_lo[off:off + size], base_hi[off:off + size]
    l2 = int(g * 4 * (n + 1) / pj.L2_TABLE_SHARE) + 64
    groups = pj.plan_groups(levels, n + 1, l2)
    assert len(groups) == -(-levels // g)
    before = pj.launches
    got = pj.descend_groups(tables, lo, hi, groups)
    torch.cuda.synchronize()
    assert pj.launches == before + len(groups)
    assert torch.equal(got, pj.jump_group_plain(tables, lo, hi))


@pytest.mark.parametrize("build", [build_graph_hybrid, build_graph_device])
def test_cuda_build_equals_oracle(cuda, build):
    tail, head = rmat_edges(14, 8 << 14, seed=5)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    pj.launches = 0
    seq, forest = build(tail, head)  # device None: the card
    assert pj.launches > 0
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)


@pytest.mark.parametrize("n", [1 << 10, 1000, 1 << 18])
def test_p1_add_one_equals_plain(cuda, n):
    x = torch.arange(n, dtype=torch.int32, device=cuda)
    x[:3] = torch.iinfo(torch.int32).max  # wraps as torch's x + 1
    before = probe.launches["add_one"]
    got = probe.add_one(x)
    torch.cuda.synchronize()
    assert probe.launches["add_one"] == before + 1
    assert torch.equal(got, probe.add_one_plain(x))
    if n % 256 == 0:
        x2 = x.reshape(n // 256, 256)
        assert torch.equal(probe.add_one(x2), x2 + 1)


@pytest.mark.parametrize("size", [1 << 18, (1 << 18) + 1, (1 << 18) + 3])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_p1_offset_views_and_ragged_n(cuda, off, size):
    """Views at storage offsets 1-3 take P1's scalar path, n % 4 != 0
    its tail; INT32_MAX wraps as torch's x + 1 does on both."""
    buf = torch.arange(size + 8, dtype=torch.int32, device=cuda)
    buf[:5] = torch.iinfo(torch.int32).max
    buf[-5:] = torch.iinfo(torch.int32).max
    x = buf[off:off + size]
    before = probe.launches["add_one"]
    got = probe.add_one(x)
    torch.cuda.synchronize()
    assert probe.launches["add_one"] == before + 1
    assert torch.equal(got, x + 1)


@pytest.mark.parametrize("lo_over", [0, 37])
@pytest.mark.parametrize("log_n", [10, 18])
def test_p2_jump_step_equals_plain(cuda, log_n, lo_over):
    """The probe's input recipe, and lo drawn past the table (clamped)."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    f = np.minimum(np.arange(n) + rng.integers(1, 64, n), n - 1)
    lo = rng.integers(0, n + lo_over, n + 3)
    hi = np.minimum(lo + rng.integers(1, 1024, n + 3), n + lo_over)
    f, lo, hi = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                 for a in (f, lo, hi))
    before = probe.launches["jump_step"]
    got = probe.jump_step(f, lo, hi)
    torch.cuda.synchronize()
    assert probe.launches["jump_step"] == before + 1
    assert torch.equal(got, probe.jump_step_plain(f, lo, hi))


@pytest.mark.parametrize("layout", ["offset1", "offset2", "offset3", "tail3",
                                    "wild", "wild_offset1"])
def test_p2_layouts_equal_plain(cuda, layout):
    """P2 on views at storage offsets 1-3 and a ragged E (its scalar path
    and tail), and with lo below 0 and past the table on the int4 and the
    scalar path: exactly its plain version, one launch."""
    n = 1 << 16
    rng = np.random.default_rng(31)
    f = np.minimum(np.arange(n) + rng.integers(1, 64, n), n - 1)
    wild = layout.startswith("wild")
    lo = rng.integers(-n - 37, n + 37, n + 8) if wild \
        else rng.integers(0, n, n + 8)
    hi = lo + rng.integers(1, 1024, n + 8)
    off = 0 if layout in ("tail3", "wild") else int(layout[-1])
    size = n + 3 if layout == "tail3" else n
    f, lo, hi = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                 for a in (f, lo, hi))
    lo, hi = lo[off:off + size], hi[off:off + size]
    before = probe.launches["jump_step"]
    got = probe.jump_step(f, lo, hi)
    torch.cuda.synchronize()
    assert probe.launches["jump_step"] == before + 1
    assert torch.equal(got, probe.jump_step_plain(f, lo, hi))


@pytest.mark.parametrize("arm", ["stream", "serial"])
def test_cuda_hybrid_arms_equal_oracle(cuda, monkeypatch, arm):
    """R-MAT 2^18 x 8 on the card: the streamed windowed tail (4 windows,
    pinned slices on the side stream) and the serial arm."""
    for k in ("SHEEP_STREAM_HANDOFF", "SHEEP_OVERLAP_HANDOFF",
              "SHEEP_HANDOFF_FACTOR", "SHEEP_PACK_HANDOFF"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    # slices small enough that the 4 windows each get some (the stream
    # caps the window count at the slice count)
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", str(1 << 14))
    if arm == "serial":
        monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "0")
        monkeypatch.setenv("SHEEP_OVERLAP_HANDOFF", "0")
    tail, head = rmat_edges(18, 8 << 18, seed=6)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    perf = {}
    pj.launches = 0
    seq, forest = build_graph_hybrid(tail, head, perf=perf)
    assert pj.launches > 0
    if arm == "stream":
        assert perf["stream_mode"] == "windowed", perf
        assert perf["fetch_windows"] == 4 and perf["packed_handoff"]
    else:
        assert "stream_mode" not in perf and perf["fetch_windows"] == 0
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)


def test_cuda_speculative_arm_raises(cuda, monkeypatch):
    """Stream off on the card is the speculative overlapped snapshot (the
    overlap's CUDA default).  The port once refused it; it now runs it,
    equal to the oracle, through K1.  (The name is the refusal's, kept.)"""
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "0")
    for k in ("SHEEP_OVERLAP_HANDOFF", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_OVERLAP_SPEC_FACTOR"):
        monkeypatch.delenv(k, raising=False)
    # a floor and slices small enough that a stream starts at this size
    monkeypatch.setenv("SHEEP_OVERLAP_MIN_MB", "0.01")
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", str(1 << 14))
    tail, head = rmat_edges(18, 8 << 18, seed=2)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    perf = {}
    pj.launches = 0
    seq, forest = build_graph_hybrid(tail, head, perf=perf)
    assert pj.launches > 0
    assert perf["overlap"] is True and perf["spec_starts"] >= 1, perf
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)


@pytest.fixture
def spec_forced(monkeypatch):
    """Force one outcome of the speculative handoff through its seams.
    "spec_complete": at each chunk after its start the stream is joined
    (left to land) before the policy looks, so the loop stops on a
    finished stream.  "spec_wait": each stream holds its last slice until
    a caller joins it, and at each chunk and at the loop's end the policy
    looks only once the stream has fetched the rest, so the loop ends
    with the stream one slice short and ``complete`` waits it out.  The
    slices copy on the side stream while the loop's next chunk runs."""
    from sheep_tpu_torch.ops import build

    class LastSliceHeld(build._StreamFetcher):
        def __init__(self, *args, **kwargs):
            self._gate = threading.Event()
            self.at_gate = threading.Event()
            super().__init__(*args, **kwargs)

        def _wait_turn(self, i):
            if i == self.total_slices - 1:
                self.at_gate.set()
                self._gate.wait(timeout=300)

        def join(self, timeout=None, mark_failed=True):
            self._gate.set()
            return super().join(timeout, mark_failed)

    def force(outcome):
        on_chunk = build._SpecHandoff.on_chunk
        complete = build._SpecHandoff.complete

        def settle(spec):
            if spec.active is None:
                return
            if outcome == "spec_complete":
                spec.active.join(timeout=300)
            else:
                spec.active.at_gate.wait(timeout=300)

        def settled_chunk(self, lo, hi, live):
            settle(self)
            return on_chunk(self, lo, hi, live)

        def settled_complete(self, lo, hi, live):
            settle(self)
            return complete(self, lo, hi, live)

        if outcome == "spec_wait":
            monkeypatch.setattr(build, "_StreamFetcher", LastSliceHeld)
        monkeypatch.setattr(build._SpecHandoff, "on_chunk", settled_chunk)
        monkeypatch.setattr(build._SpecHandoff, "complete", settled_complete)

    return force


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("outcome", ["spec_complete", "spec_wait"])
def test_cuda_spec_arm_hands_off_streamed_snapshot(cuda, monkeypatch,
                                                   spec_forced, outcome,
                                                   packed):
    """The speculative arm on the card handing off the snapshot its stream
    fetched on the side stream while later chunks ran: the stream stops
    the loop (spec_complete) or is waited out at the end (spec_wait),
    6-byte packed and in int32 pairs, where the stream reads the loop's
    own lo and hi.  Equal to the oracle, through K1."""
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "0")
    monkeypatch.delenv("SHEEP_OVERLAP_HANDOFF", raising=False)
    monkeypatch.setenv("SHEEP_OVERLAP_MIN_MB", "0.01")
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", str(1 << 14))
    monkeypatch.setenv("SHEEP_OVERLAP_SPEC_FACTOR", "64")
    # the card's default, so a chunk follows the stream's start
    monkeypatch.setenv("SHEEP_HANDOFF_FACTOR", "3")
    if packed:
        monkeypatch.delenv("SHEEP_PACK_HANDOFF", raising=False)
    else:
        monkeypatch.setenv("SHEEP_PACK_HANDOFF", "0")
    spec_forced(outcome)
    tail, head = rmat_edges(18, 8 << 18, seed=2)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    perf = {}
    pj.launches = 0
    seq, forest = build_graph_hybrid(tail, head, perf=perf)
    assert pj.launches > 0
    assert perf["spec_mode"] == outcome, perf
    assert perf["packed_handoff"] is packed, perf
    assert perf["spec_stopped_loop"] is (outcome == "spec_complete"), perf
    assert perf["spec_fetch_phases"]["slices"] >= 1, perf
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)


@pytest.mark.parametrize("layout", ["aligned", "offset1", "offset2",
                                    "offset3", "tail1", "tail2", "tail3"])
def test_k1_wild_lo_equals_plain(cuda, layout):
    """K1 with lo below 0 (past the wrap too) and past the table on its
    three load paths (int4 when aligned, scalar on views at storage
    offsets 1-3, the E % 4 tail): exactly its plain version, which counts
    a negative lo from the end as jnp does, then clamps."""
    n, levels, e = 1 << 14, 3, 50_000
    rng = np.random.default_rng(41)
    f = np.minimum(np.arange(n + 1) + rng.integers(1, 64, n + 1), n)
    lo = rng.integers(-n - 37, n + 37, e + 8)
    hi = lo + rng.integers(-3, 1024, e + 8)
    f, lo, hi = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                 for a in (f, lo, hi))
    tables = pj.lift_tables(f, levels)
    off = int(layout[-1]) if layout.startswith("offset") else 0
    size = e + (int(layout[-1]) if layout.startswith("tail") else 0)
    lo, hi = lo[off:off + size], hi[off:off + size]
    before = pj.launches
    got = pj.jump_group_cuda(tables, lo, hi)
    torch.cuda.synchronize()
    assert pj.launches == before + 1
    assert torch.equal(got, pj.jump_group_plain(tables, lo, hi))
    # the ROADMAP's input: f = arange(100, 200), lo = [-3] gives [197]
    f1 = torch.arange(100, 200, dtype=torch.int32, device=cuda)[None, :]
    one = torch.tensor([-3], dtype=torch.int32, device=cuda)
    big = torch.tensor([1000], dtype=torch.int32, device=cuda)
    assert pj.jump_group_cuda(f1, one, big).tolist() == [197]


def _resilient_graph():
    tail, head = rmat_edges(14, 8 << 14, seed=5)
    want_seq = degree_sequence(tail, head)
    return tail, head, want_seq, build_forest(tail, head, want_seq)


def _resilient(tmp_path, **kw):
    from sheep_tpu_torch.runtime import RuntimeConfig, build_graph_resilient

    tail, head, want_seq, want = _resilient_graph()
    pj.load_library()  # built before any watchdog starts timing
    cfg = RuntimeConfig(checkpoint_dir=str(tmp_path), backoff_base_s=0.0,
                        ladder=("single", "host"), **kw)
    pj.launches = 0
    seq, forest = build_graph_resilient(tail, head, config=cfg)  # the card
    torch.cuda.synchronize()
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)
    return cfg, pj.launches


def test_cuda_resilient_build_equals_oracle(cuda, tmp_path):
    """The fault-tolerant build on the card: the single rung's chunks
    descend through K1, every boundary checkpoints, nothing degrades, and
    the kill at boundary 1 resumes to the same forest."""
    from sheep_tpu_torch.runtime import (BuildKilled, FaultPlan, clear_plan,
                                         install_plan)

    cfg, launches = _resilient(tmp_path)
    kinds = [e[0] for e in cfg.events]
    assert launches > 0
    assert kinds.count("checkpoint") >= 2 and "degrade" not in kinds
    install_plan(FaultPlan(site="boundary", at=1, kind="kill"))
    try:
        with pytest.raises(BuildKilled):
            _resilient(tmp_path)
    finally:
        clear_plan()
    cfg, launches = _resilient(tmp_path, resume=True)
    kinds = [e[0] for e in cfg.events]
    assert "resume" in kinds and "degrade" not in kinds, cfg.events
    assert launches > 0  # the resumed chunks ran on the card, through K1


def test_cuda_resilient_k1_launch_failure_fails_the_build(cuda, tmp_path,
                                                         monkeypatch):
    """K1 failing to launch is not retried and does not degrade: the build
    raises, and the host rung never finishes the card's work."""
    from sheep_tpu_torch.runtime import RuntimeConfig, build_graph_resilient

    real = pj.load_library()

    class FailingK1:
        def __getattr__(self, name):
            return getattr(real, name)

        def sheep_fused_jump(self, *args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(pj, "load_library", lambda: FailingK1())
    tail, head, _, _ = _resilient_graph()
    cfg = RuntimeConfig(checkpoint_dir=str(tmp_path), backoff_base_s=0.0,
                        ladder=("single", "host"))
    with pytest.raises(RuntimeError, match="fused_jump kernel launch failed"):
        build_graph_resilient(tail, head, config=cfg)
    kinds = [e[0] for e in cfg.events]
    assert "retry" not in kinds and "degrade" not in kinds, cfg.events


def test_cuda_resilient_real_oom_degrades(cuda, tmp_path, monkeypatch):
    """A chunk dispatch that raises a real torch.cuda.OutOfMemoryError (an
    impossible allocation on the card) is classified retryable, exhausts
    its budget and degrades to the host rung, equal to the oracle."""
    from sheep_tpu_torch.ops import forest as pf
    from sheep_tpu_torch.runtime import is_retryable

    def oom_chunk(lo, hi, n, levels, jrounds):
        torch.empty(1 << 50, dtype=torch.uint8, device=lo.device)
        raise AssertionError("an allocation of 1 PiB succeeded")

    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        oom_chunk(torch.zeros(1, device=cuda), None, 0, 0, 0)
    assert is_retryable(info.value)
    monkeypatch.setattr(pf, "fixpoint_chunk", oom_chunk)
    cfg, _ = _resilient(tmp_path, max_retries=1)
    assert [e[0] for e in cfg.events].count("retry") == 1
    degrades = [e for e in cfg.events if e[0] == "degrade"]
    assert len(degrades) == 1 and "OutOfMemoryError" in degrades[0][3]


def test_cuda_resilient_watchdog_on_a_held_dispatch(cuda, tmp_path,
                                                    monkeypatch):
    """A chunk dispatch held on the card (torch.cuda._sleep, about 2 s)
    under a 0.3 s watchdog: DeadlineExceeded on queued CUDA work
    (DeviceHung), which gives the rung up at once, and the host rung
    finishes, equal to the oracle."""
    from sheep_tpu_torch.ops import forest as pf

    real = pf.fixpoint_chunk

    def held_chunk(lo, hi, n, levels, jrounds):
        torch.cuda._sleep(4_000_000_000)
        return real(lo, hi, n, levels, jrounds)

    monkeypatch.setattr(pf, "fixpoint_chunk", held_chunk)
    cfg, _ = _resilient(tmp_path, watchdog_s=0.3)
    degrades = [e for e in cfg.events if e[0] == "degrade"]
    assert len(degrades) == 1 and "DeviceHung" in degrades[0][3], cfg.events


def test_cuda_watchdog_enqueues_on_the_callers_stream(cuda):
    """The watchdog's helper thread runs the dispatch on the caller's
    current stream (torch's current stream is per thread), and the
    attempt's outputs are ready when it returns."""
    from sheep_tpu_torch.runtime.retry import call_with_watchdog

    side = torch.cuda.Stream()
    seen = []

    def dispatch(j):
        seen.append(torch.cuda.current_stream())
        x = torch.arange(1 << 20, device="cuda", dtype=torch.int32)
        return x + j

    with torch.cuda.stream(side):
        out = call_with_watchdog(dispatch, 3, 30.0)
        assert seen == [side]
        assert torch.cuda.current_stream() == side
    assert int(out[5]) == 8
    out = call_with_watchdog(dispatch, 1, None)  # no watchdog: this thread
    assert seen[-1] == torch.cuda.current_stream() and int(out[0]) == 1


def test_cuda_graph2tree_ir_on_hepth(cuda, tmp_path, capsys):
    """The user's entry point on the card: ``graph2tree data/hep-th.dat -i
    -r -f -c`` prints the golden TREEFAQS line and ``Tree is valid.``, and
    its build launched K1."""
    import os

    from sheep_tpu_torch.cli import graph2tree

    hep = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "hep-th.dat")
    pj.launches = 0
    assert graph2tree.main([hep, "-i", "-r", "-f", "-c", "-o",
                            str(tmp_path / "t.tre")]) == 0
    torch.cuda.synchronize()
    assert pj.launches > 0
    out = capsys.readouterr().out
    assert ("TREEFAQS: width:24\troots:581\n\tvheight:754\teheight:2330\n"
            "\tverts:7610\tedges:15751\n\thalo:3532\tcore:0\n\tfill:0\n"
            ) in out
    assert "Tree is valid." in out and "Reduced in:" in out
    from sheep_tpu_torch.io import load_edges, read_tree

    el = load_edges(hep)
    want = build_forest(el.tail, el.head, degree_sequence(el.tail, el.head))
    parent, pst = read_tree(str(tmp_path / "t.tre"))
    assert np.array_equal(parent, want.parent)
    assert np.array_equal(pst, want.pst_weight)
