"""The port's streamed windowed handoff (sheep_tpu_torch/ops/build.py:
_StreamFetcher, _WindowStream, _stream_tail and the streamed prep of
build_graph_hybrid) equals sheep_tpu's (JAX on the CPU), the port's own
serial arm and the host oracle bit for bit: the window-count sweep, the
card's window queue forced onto CPU tensors (packed and pair), the serial
fallback on a fetch or fold failure, the host-seq arm, the reduced
multiset's prep pst, a partial given order, the fetcher's modes, and the
speculative arm (stream off, overlap on) run."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sheep_tpu.ops.build as RB
from sheep_tpu.core import build_forest, degree_sequence

import sheep_tpu_torch.core.forest as PCF
import sheep_tpu_torch.ops.build as PB
from sheep_tpu_torch.utils import rmat_edges

CPU = torch.device("cpu")


@pytest.fixture
def stream_env(monkeypatch):
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "1")
    for k in ("SHEEP_HANDOFF_WINDOWS", "SHEEP_STREAM_DEVICE_WINDOWS",
              "SHEEP_STREAM_HOST_SEQ", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_OVERLAP_HANDOFF", "SHEEP_PACK_HANDOFF",
              "SHEEP_OVERLAP_SLICE"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _graph(log_n=12, seed=3):
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=seed)
    return n, tail, head


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].parent, want[1].parent)
    np.testing.assert_array_equal(got[1].pst_weight, want[1].pst_weight)


def _serial(tail, head, n, env, **kw):
    """The port's serial arm on the same input."""
    env.setenv("SHEEP_STREAM_HANDOFF", "0")
    env.setenv("SHEEP_OVERLAP_HANDOFF", "0")
    out = PB.build_graph_hybrid(tail, head, n, device="cpu", **kw)
    env.setenv("SHEEP_STREAM_HANDOFF", "1")
    env.delenv("SHEEP_OVERLAP_HANDOFF")
    return out


def _oracle(tail, head, seq=None, max_vid=None):
    seq = degree_sequence(tail, head) if seq is None else seq
    return seq, build_forest(tail, head, seq, max_vid=max_vid)


@pytest.mark.parametrize("device_windows", [False, True])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_windowed_parity_sweep(stream_env, w, device_windows):
    """W in {1, 2, 4, 8}, windows split on the host or streamed by the
    window queue: equal to the serial arm, the reference and the oracle."""
    n, tail, head = _graph()
    serial = _serial(tail, head, n, stream_env)
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", str(w))
    if device_windows:
        stream_env.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
        stream_env.setenv("SHEEP_OVERLAP_SLICE", "512")
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["stream_mode"] == "windowed", perf
    assert perf["fetch_windows"] == w
    assert len(perf["window_fetch_s"]) == len(perf["window_fold_s"]) == w
    assert 0.0 <= perf["overlap_frac"] <= 1.0
    _same(got, serial)
    _same(got, RB.build_graph_hybrid(tail, head, n))
    _same(got, _oracle(tail, head))


@pytest.mark.parametrize("packed", [False, True])
def test_device_window_queue_forced_on_cpu(stream_env, packed):
    """The card's transfer path (device hi-sort + _WindowStream slices,
    prefetch depth 2) on CPU tensors, packed and pair modes, against the
    reference forced the same way."""
    n, tail, head = _graph()
    serial = _serial(tail, head, n, stream_env)
    stream_env.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    # small enough that each of the 4 windows gets a slice
    stream_env.setenv("SHEEP_OVERLAP_SLICE", "2048")
    if packed:
        stream_env.setenv("SHEEP_PACK_HANDOFF", "1")
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["stream_mode"] == "windowed", perf
    assert perf["packed_handoff"] is packed
    assert perf["fetch_windows"] == 4
    _same(got, serial)
    _same(got, RB.build_graph_hybrid(tail, head, n))


def test_mid_stream_fetch_failure_falls_back_serial(stream_env,
                                                    monkeypatch):
    """A slice fetch dying mid-stream degrades to the serial fetch of the
    same device arrays: exact, and stream_mode says so."""
    n, tail, head = _graph()
    serial = _serial(tail, head, n, stream_env)
    stream_env.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    stream_env.setenv("SHEEP_OVERLAP_SLICE", "4096")
    real = PB._slice_rows
    calls = {"n": 0}

    def flaky(buf, start, length):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected slice fault")
        return real(buf, start, length)

    monkeypatch.setattr(PB, "_slice_rows", flaky)
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["stream_mode"] == "fallback:RuntimeError", perf
    assert calls["n"] >= 3
    _same(got, serial)
    _same(got, _oracle(tail, head))


def test_mid_fold_failure_falls_back_serial(stream_env, monkeypatch):
    """A fold block raising mid-stream falls back to the serial fetch and
    the monolithic fold."""
    n, tail, head = _graph()
    serial = _serial(tail, head, n, stream_env)
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    real = PCF.links_fold
    calls = {"n": 0}

    def flaky_fold(n_, pst=None):
        fold = real(n_, pst)
        orig_block = fold.block

        def block(lo, hi):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected fold fault")
            return orig_block(lo, hi)

        fold.block = block
        return fold

    monkeypatch.setattr(PCF, "links_fold", flaky_fold)
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["stream_mode"] == "fallback:RuntimeError", perf
    _same(got, serial)
    _same(got, _oracle(tail, head))


def test_host_seq_arm_parity(stream_env):
    """The host-seq prep and the device-seq prep give the same output, as
    the reference's two arms and the oracle do."""
    n, tail, head = _graph(seed=11)
    stream_env.setenv("SHEEP_STREAM_HOST_SEQ", "1")
    perf_a = {}
    got_a = PB.build_graph_hybrid(tail, head, n, perf=perf_a, device="cpu")
    want_a = RB.build_graph_hybrid(tail, head, n)
    stream_env.setenv("SHEEP_STREAM_HOST_SEQ", "0")
    perf_b = {}
    got_b = PB.build_graph_hybrid(tail, head, n, perf=perf_b, device="cpu")
    want_b = RB.build_graph_hybrid(tail, head, n)
    # the host-seq arm has nothing to prefetch; the device arm does
    assert "prefetch_s" not in perf_a and "prefetch_s" in perf_b
    for got, want in ((got_a, want_a), (got_b, want_b),
                      (got_a, got_b), (got_a, _oracle(tail, head))):
        _same(got, want)


def test_reduced_multiset_uses_prep_pst(stream_env):
    """A small handoff factor forces reduce rounds (the multiset is
    rewritten), so the fold takes the prep-time pst: still exact."""
    n, tail, head = _graph(seed=7)
    stream_env.setenv("SHEEP_HANDOFF_FACTOR", "2")
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["rounds"] > 0 and perf["stream_mode"] == "windowed"
    _same(got, _oracle(tail, head))
    _same(got, RB.build_graph_hybrid(tail, head, n))


def test_given_seq_partial_stays_exact(stream_env):
    """A given PARTIAL order (absent vids -> pst-only links that never
    reach the stream) keeps the absent-vid pst contract."""
    n, tail, head = _graph(seed=5)
    full = degree_sequence(tail, head)
    sub = full[: len(full) // 2]
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    got = PB.build_graph_hybrid(tail, head, n, seq=sub, device="cpu")
    _same(got, _oracle(tail, head, sub, max_vid=n - 1))
    _same(got, RB.build_graph_hybrid(tail, head, n, seq=sub))


def test_cpu_default_is_reference_cpu_default(stream_env):
    """No knob set: build_graph_hybrid(device="cpu") runs the reference's
    CPU default (stream on, host seq, immediate handoff, one window)."""
    n, tail, head = _graph(seed=13)
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["stream_mode"] == "windowed" and perf["fetch_windows"] == 1
    assert perf["rounds"] == 0 and "prefetch_s" not in perf
    assert perf["pst_wait_s"] == 0.0  # the fold counted pst itself
    _same(got, RB.build_graph_hybrid(tail, head, n))


def test_stream_gates(stream_env):
    """The streamed tail's gates keep the reference's defaults: its CPU
    values on the CPU, its accelerator values on CUDA, the same env
    overrides."""
    cuda = torch.device("cuda")
    assert PB.stream_handoff_enabled() is RB.stream_handoff_enabled() is True
    assert PB.handoff_windows(1 << 22, CPU) == RB.handoff_windows(1 << 22) \
        == 1
    assert PB.handoff_windows(1 << 20, cuda) == 4
    assert PB.handoff_windows((1 << 20) - 1, cuda) == 1
    assert PB.host_seq_mode(CPU) is RB.host_seq_mode() is True
    assert PB.host_seq_mode(cuda) is False
    assert PB._overlap_enabled(CPU) is RB._overlap_enabled() is False
    assert PB._overlap_enabled(cuda) is True
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "3")
    stream_env.setenv("SHEEP_STREAM_HOST_SEQ", "0")
    assert PB.handoff_windows(10, cuda) == RB.handoff_windows(10) == 3
    assert PB.host_seq_mode(CPU) is RB.host_seq_mode() is False
    stream_env.delenv("SHEEP_STREAM_HANDOFF")
    stream_env.setenv("SHEEP_OVERLAP_HANDOFF", "1")
    assert PB.stream_handoff_enabled() is RB.stream_handoff_enabled() \
        is False
    stream_env.setenv("SHEEP_STREAM_HANDOFF", "0")
    stream_env.setenv("SHEEP_OVERLAP_HANDOFF", "0")
    assert PB.stream_handoff_enabled() is RB.stream_handoff_enabled() \
        is False


@pytest.mark.parametrize("stream", ["0", ""])
def test_speculative_overlap_arm_raises(stream_env, stream):
    """Stream off and overlap on, explicitly or by the overlap alone, is
    the speculative overlapped snapshot (_SpecHandoff).  The port once
    refused it; it now runs it, and equals sheep_tpu's hybrid under the
    same environment and the oracle.  (The name is the refusal's, kept.)"""
    n, tail, head = _graph(log_n=10)
    if stream:
        stream_env.setenv("SHEEP_STREAM_HANDOFF", stream)
    else:
        stream_env.delenv("SHEEP_STREAM_HANDOFF")
    stream_env.setenv("SHEEP_OVERLAP_HANDOFF", "1")
    stream_env.setenv("SHEEP_OVERLAP_MIN_MB", "0.0001")
    stream_env.setenv("SHEEP_OVERLAP_SLICE", "512")
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, handoff_factor=1, perf=perf,
                                device="cpu")
    assert "stream_mode" not in perf and perf["overlap"] is True, perf
    assert perf["spec_starts"] >= 1, perf
    _same(got, RB.build_graph_hybrid(tail, head, n, handoff_factor=1))
    _same(got, _oracle(tail, head))


def _links(rng, n, live, pad):
    lo = np.full(pad, n, np.int64)
    hi = np.full(pad, n, np.int64)
    lo[:live] = rng.integers(0, n - 1, live)
    hi[:live] = rng.integers(0, n - 1, live)
    return lo, hi


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("n", [1 << 20, (1 << 24) + 5])
def test_stream_fetcher_packed_and_pair_modes(stream_env, n):
    """The fetcher delivers the exact snapshot in the 6-byte-packed
    (n < 2^24) and int32-pair (n >= 2^24) modes, as the reference's."""
    stream_env.setenv("SHEEP_PACK_HANDOFF", "1")
    rng = np.random.default_rng(94)
    live, pad = 9000, 1 << 14
    lo, hi = _links(rng, n, live, pad)
    f = PB._StreamFetcher(_t(lo), _t(hi), n, live, slice_links=2048)
    assert not f.join(timeout=60)
    assert f.finished() and not f.failed
    assert f.packed is (n < (1 << 24))
    got_lo, got_hi = f.collect()
    keep = got_lo < n
    np.testing.assert_array_equal(got_lo[keep], lo[:live])
    np.testing.assert_array_equal(got_hi[keep], hi[:live])
    assert f.remaining_bytes() == 0
    rf = RB._StreamFetcher(jnp.asarray(lo, jnp.int32),
                           jnp.asarray(hi, jnp.int32), n, live,
                           slice_links=2048)
    rf.join()
    for g, w in zip(f.collect(), rf.collect()):
        np.testing.assert_array_equal(g, w)
    assert (f.slice_len, f.total_slices, f.packed) == \
        (rf.slice_len, rf.total_slices, rf.packed)


def test_stream_fetcher_non_pow2_slice_covers_all(stream_env):
    """A non-power-of-two SHEEP_OVERLAP_SLICE rounds down to a power of
    two, so slices tile the pow2 width and no tail link is dropped."""
    n, pad = 1 << 20, 1 << 14
    live = pad - 100
    lo, hi = _links(np.random.default_rng(96), n, live, pad)
    f = PB._StreamFetcher(_t(lo), _t(hi), n, live, slice_links=3000)
    assert f.slice_len == 2048
    assert not f.join(timeout=60)
    assert f.finished()
    got_lo, got_hi = f.collect()
    keep = got_lo < n
    np.testing.assert_array_equal(got_lo[keep], lo[:live])
    np.testing.assert_array_equal(got_hi[keep], hi[:live])


def test_stream_fetcher_abort_keeps_prefix(stream_env):
    n, pad = 1 << 20, 1 << 14
    rng = np.random.default_rng(95)
    lo = rng.integers(0, n - 1, pad)
    hi = rng.integers(0, n - 1, pad)
    f = PB._StreamFetcher(_t(lo), _t(hi), n, pad, slice_links=1024)
    f.abort()  # immediately: whatever landed must be a prefix
    assert f.failed is False, "abort must not poison a healthy stream"
    assert not f._thread.is_alive()
    got_lo, got_hi = f.collect()
    k = len(got_lo)
    assert k % 1024 == 0 and k == f.done_slices * 1024
    np.testing.assert_array_equal(got_lo, lo[:k])
    np.testing.assert_array_equal(got_hi, hi[:k])


def test_window_stream_under_thread_churn(stream_env):
    """The window queue's hand-off between the fetch thread and the
    consumer under a 1 µs switch interval: every window arrives whole and
    in order, with at most PREFETCH windows resident ahead of the fold."""
    n, pad = 1 << 16, 1 << 15
    live = pad - 7
    lo, hi = _links(np.random.default_rng(97), n, live, pad)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        s = PB._WindowStream(_t(lo), _t(hi), n, live, slice_links=512,
                             windows=8)
        got = []
        for k in range(s.windows):
            resident = sum(x is not None for x in s._slices)
            ahead = s._cuts[min(k + 1 + s.PREFETCH, s.windows)]
            assert resident <= ahead - s._cuts[k]
            got.append(s.window(k, timeout_s=60))
        assert not s.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert s.windows == 8 and not s.failed
    got_lo = np.concatenate([g[0] for g in got])
    got_hi = np.concatenate([g[1] for g in got])
    np.testing.assert_array_equal(got_lo[:live], lo[:live])
    np.testing.assert_array_equal(got_hi[:live], hi[:live])
