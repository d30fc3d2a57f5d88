"""The port on the card: kernels K1, P1 and P2 against their plain
versions (K1 also in forced table groupings; K1, P1 and P2 on views that
are not 16-byte aligned and on ragged lengths; K1 and P2 also with lo
below 0 and past the table), the CUDA builds (the hybrid on the
streamed and serial arms) against the port's host oracle,
the hybrid's card-counted pst and side-stream fetch of seq and pst
against the CPU build, the out-of-core build's block intake on the card
against the CPU build and within the peak of the host route it replaced,
and the fault-tolerant build on the card (K1 on its single rung, a kill
and resume, a real CUDA out-of-memory error and a watchdog on a held
dispatch, each degrading to the host rung, and the watchdog's stream;
a degrade from the single rung to the external-memory rung), and
``graph2tree -i -r`` on hep-th, the user's entry point to K1, also in
the treewidth mode, and the sharded mesh build with its workers on the
card (``parallel.mesh.mesh_devices`` patched), its map-only partials and
the resilient build's mesh rung.

Marked ``cuda``; each test skips without a CUDA device (the kernels are
CUDA kernels with no CPU or interpret mode).  This file imports no jax, so it
runs on the GPU machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sheep_tpu_torch.core import build_forest, degree_sequence
from sheep_tpu_torch.obs import trace as obs
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
    for k in ("SHEEP_STREAM_HANDOFF", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_PACK_HANDOFF"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    # slices small enough that the 4 windows each get some (the stream
    # caps the window count at the slice count)
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", str(1 << 14))
    if arm == "serial":
        monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "0")
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


@pytest.mark.parametrize("given", [False, True])
def test_cuda_hybrid_counts_pst_on_the_card(cuda, monkeypatch, given):
    """Numpy inputs on the card, 2^18 slots x 2^21 records: the prep
    counts pst and the prefetch fetches seq and pst on a side stream (for
    a given order, pst alone), equal to the CPU build bit for bit, with
    no host pst pass."""
    for k in ("SHEEP_STREAM_HANDOFF", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_PACK_HANDOFF", "SHEEP_HANDOFF_WINDOWS",
              "SHEEP_OVERLAP_SLICE"):
        monkeypatch.delenv(k, raising=False)
    n = 1 << 18
    tail, head = rmat_edges(18, 8 << 18, seed=9)
    seq = None
    if given:
        full = degree_sequence(tail, head)
        seq = full[: len(full) * 2 // 3]
    want_seq, want = build_graph_hybrid(tail, head, n, seq=seq,
                                        device="cpu")
    perf = {}
    with obs.capture() as cap:
        got_seq, got = build_graph_hybrid(tail, head, n, seq=seq, perf=perf)
    np.testing.assert_array_equal(got_seq, want_seq)
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.pst_weight, want.pst_weight)
    assert perf["pst_source"] == "card"
    assert "prefetch_pst_s" not in perf and "prefetch_seq_s" not in perf
    assert not cap.named("build.prefetch.pst")
    assert not cap.named("build.prefetch.seq")
    [pre] = cap.named("build.prefetch")
    assert pre.attrs == {"source": "card",
                         "bytes": (1 if given else 2) * n * 4}


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


def test_cuda_stream_intake_equals_cpu_within_the_old_peak(cuda,
                                                           monkeypatch):
    """The out-of-core build on the card, 2^18 slots x 2^21 records in
    blocks of 3 x 2^17 (the last one short): each block's exact int32
    records crossing and padded on the card, the position table mapped
    there.  Equal to the CPU build, and its allocated peak no higher than
    that of the int64 host route it replaced (copied here)."""
    from sheep_tpu_torch.ops import stream

    for k in ("SHEEP_STREAM_HANDOFF", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_PACK_HANDOFF", "SHEEP_HANDOFF_WINDOWS",
              "SHEEP_OVERLAP_SLICE", "SHEEP_STREAM_DEVICE_WINDOWS"):
        monkeypatch.delenv(k, raising=False)
    slots, block = 1 << 18, 3 << 17
    tail, head = rmat_edges(18, 8 << 18, seed=12)
    seq = degree_sequence(tail, head, slots)
    pos = np.full(slots, 0xFFFFFFFF, np.uint32)
    pos[seq] = np.arange(len(seq), dtype=np.uint32)

    def blocks():
        for s in range(0, len(tail), block):
            yield tail[s:s + block], head[s:s + block]

    def build(device, perf=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f, _ = stream.build_graph_streaming_hosted(
            blocks(), len(seq), pos, block, device=device, perf=perf)
        return f, torch.cuda.max_memory_allocated()

    want, _ = build("cpu")
    perf = {}
    got, peak = build(cuda, perf)
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.pst_weight, want.pst_weight)
    assert perf["blocks"] == 6 and len(tail) % block
    assert perf["block_upload_bytes"] == 8 * len(tail)

    def int64_padded_block(tail, head, buf, vid_pad, pad_s=None,
                           upload_s=None, upload_bytes=None):
        block_edges, device = buf
        b = len(tail)
        t = np.full(block_edges, vid_pad, dtype=np.int64)
        h = np.full(block_edges, vid_pad, dtype=np.int64)
        t[:b] = tail
        h[:b] = head
        return (torch.from_numpy(t.astype(np.int32)).to(device),
                torch.from_numpy(h.astype(np.int32)).to(device))

    monkeypatch.setattr(stream, "_block_buffers", lambda b, d: (b, d))
    monkeypatch.setattr(stream, "_padded_block", int64_padded_block)
    monkeypatch.setattr(stream, "_device_vid_pos", lambda p, n, d: (
        torch.from_numpy(stream._full_vid_pos(p, n)).to(d)))
    old, old_peak = build(cuda)
    np.testing.assert_array_equal(old.parent, want.parent)
    assert peak <= old_peak, (peak, old_peak)


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


def test_cuda_graph2tree_ir_treewidth_on_hepth(cuda, tmp_path, capsys):
    """The treewidth mode with ``-i -r``: the degree sort on the card,
    then the host insert; ``width:551`` and ``Tree is valid.``, and the
    serial route's tree."""
    import os

    from sheep_tpu_torch.cli import graph2tree

    hep = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "hep-th.dat")
    args = ["-k", "-e", "-j", "-f", "-c", "-o"]
    assert graph2tree.main([hep, "-i", "-r", *args,
                            str(tmp_path / "ir.tre")]) == 0
    out = capsys.readouterr().out
    assert "TREEFAQS: width:551\troots:581\n" in out
    assert "Tree is valid." in out and "Reduced in:" in out
    assert graph2tree.main([hep, *args, str(tmp_path / "serial.tre")]) == 0
    assert "TREEFAQS: width:551\troots:581\n" in capsys.readouterr().out
    for suffix in ("", ".sum"):
        assert (tmp_path / f"ir.tre{suffix}").read_bytes() == \
            (tmp_path / f"serial.tre{suffix}").read_bytes()


def test_cuda_resilient_degrades_single_to_ext(cuda, tmp_path):
    """The ext rung on the card's ladder: K1 launches on single, whose
    second dispatch then fails for good; the ladder degrades to ext,
    which re-streams the .dat file, equal to the oracle."""
    from sheep_tpu_torch.io import write_dat
    from sheep_tpu_torch.runtime import (FaultPlan, RuntimeConfig,
                                         build_graph_resilient, clear_plan,
                                         install_plan, reset_counters)

    tail, head = rmat_edges(16, 8 << 16, seed=3)
    path = str(tmp_path / "g.dat")
    write_dat(path, tail, head)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    cfg = RuntimeConfig(ladder=("single", "ext"), edges_path=path,
                        max_retries=1, backoff_base_s=0.0)
    pj.launches = 0
    reset_counters()
    install_plan(FaultPlan("chunk", 1, "xla", -1))
    try:
        seq, forest = build_graph_resilient(tail, head, config=cfg)
    finally:
        clear_plan()
        reset_counters()
    assert pj.launches > 0
    assert [e[:3] for e in cfg.events if e[0] == "degrade"] == \
        [("degrade", "single", "ext")]
    assert any(e[0] == "ext-block" for e in cfg.events)
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)


@pytest.fixture
def card_workers(monkeypatch):
    """``use(w)`` gives the port's mesh w workers on the one card, through
    the seam ``parallel.mesh.mesh_devices``."""
    from sheep_tpu_torch.parallel import mesh

    def use(w):
        monkeypatch.setattr(mesh, "mesh_devices",
                            lambda device: [torch.device("cuda", 0)] * w)
    return use


@pytest.mark.parametrize("kernel", ["chunked", "loop"])
@pytest.mark.parametrize("w", [2, 3])
def test_cuda_mesh_build_equals_oracle(cuda, card_workers, monkeypatch, w,
                                       kernel):
    """The sharded mesh build with its workers on the card: the forest is
    the oracle's, and on the chunked kernel every worker's rounds
    launched K1; the map-only partials merge on the card to the tree."""
    from sheep_tpu_torch.ops.forest import merge_forests_device
    from sheep_tpu_torch.parallel import (build_graph_distributed,
                                          map_graph_distributed)

    card_workers(w)
    monkeypatch.setenv("SHEEP_MESH_KERNEL", kernel)
    tail, head = rmat_edges(14, 8 << 14, seed=5)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    tm = {}
    pj.launches = 0
    seq, forest = build_graph_distributed(tail, head, num_workers=w,
                                          timings=tm)
    torch.cuda.synchronize()
    assert pj.launches > 0
    if kernel == "chunked":
        assert len(tm["k1_by_worker"]) == w and min(tm["k1_by_worker"]) > 0
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)
    _, parts = map_graph_distributed(tail, head, num_workers=w)
    merged = merge_forests_device(*parts)
    np.testing.assert_array_equal(merged.parent, want.parent)
    np.testing.assert_array_equal(merged.pst_weight, want.pst_weight)


def test_cuda_resilient_mesh_rung(cuda, card_workers, tmp_path):
    """The ladder starts at the mesh rung on a mesh of two workers on the
    card: no degrade, K1 launched, the oracle's forest; a kill at its
    second boundary resumes on the mesh rung to the same forest."""
    from sheep_tpu_torch.runtime import (BuildKilled, FaultPlan,
                                         RuntimeConfig, build_graph_resilient,
                                         clear_plan, install_plan)

    card_workers(2)
    tail, head = rmat_edges(14, 8 << 14, seed=6)
    want = build_forest(tail, head, degree_sequence(tail, head))
    ladder = ("mesh", "single", "host")

    def run(**kw):
        cfg = RuntimeConfig(checkpoint_dir=str(tmp_path), ladder=ladder,
                            backoff_base_s=0.0, **kw)
        pj.launches = 0
        _, forest = build_graph_resilient(tail, head, config=cfg)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(forest.parent, want.parent)
        np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)
        return cfg

    cfg = run()
    assert pj.launches > 0
    assert ("checkpoint", "mesh", 0) in cfg.events
    assert not any(e[0] == "degrade" for e in cfg.events)
    install_plan(FaultPlan(site="boundary", at=1, kind="kill"))
    try:
        with pytest.raises(BuildKilled):
            run()
    finally:
        clear_plan()
    cfg = run(resume=True)
    assert [e[1] for e in cfg.events if e[0] == "resume"] == ["mesh"]
    assert not any(e[0] == "degrade" for e in cfg.events)
