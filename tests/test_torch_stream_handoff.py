"""The port's streamed windowed handoff (sheep_tpu_torch/ops/build.py:
_WindowStream, _stream_tail and the streamed prep of build_graph_hybrid)
equals sheep_tpu's (JAX on the CPU), the port's own serial arm and the
host oracle bit for bit: the window-count sweep, the card's window queue
forced onto CPU tensors (packed and pair), the serial fallback on a fetch
or fold failure, the host-seq arm, the reduced multiset's prep pst, a
partial given order, the window stream's modes, cut rule, abort and
breakdown, and each packed arm's native unpack."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sheep_tpu.ops.build as RB
from sheep_tpu.core import build_forest, degree_sequence

import sheep_tpu_torch.core.forest as PCF
import sheep_tpu_torch.ops.build as PB
from sheep_tpu_torch.obs import trace as obs
from sheep_tpu_torch.utils import rmat_edges

CPU = torch.device("cpu")


@pytest.fixture
def stream_env(monkeypatch):
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "1")
    for k in ("SHEEP_HANDOFF_WINDOWS", "SHEEP_STREAM_DEVICE_WINDOWS",
              "SHEEP_STREAM_HOST_SEQ", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_PACK_HANDOFF", "SHEEP_OVERLAP_SLICE"):
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
    out = PB.build_graph_hybrid(tail, head, n, device="cpu", **kw)
    env.setenv("SHEEP_STREAM_HANDOFF", "1")
    return out


def _oracle(tail, head, seq=None, max_vid=None):
    seq = degree_sequence(tail, head) if seq is None else seq
    return seq, build_forest(tail, head, seq, max_vid=max_vid)


@pytest.mark.parametrize("device_windows", [False, True, "packed"])
@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_windowed_parity_sweep(stream_env, w, device_windows):
    """W in {1, 2, 4, 8}, windows split on the host or streamed by the
    window queue, in int32 pairs or 6-byte packed (the card's default
    under 2^24, unpacked by ``native.unpack_links_6b``): equal to the
    serial arm, the reference and the oracle."""
    n, tail, head = _graph()
    if device_windows == "packed":
        stream_env.setenv("SHEEP_PACK_HANDOFF", "1")
    serial = _serial(tail, head, n, stream_env)
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", str(w))
    if device_windows:
        stream_env.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
        stream_env.setenv("SHEEP_OVERLAP_SLICE", "512")
    perf = {}
    got = PB.build_graph_hybrid(tail, head, n, perf=perf, device="cpu")
    assert perf["stream_mode"] == "windowed", perf
    assert perf["fetch_windows"] == w
    assert perf["packed_handoff"] is (device_windows == "packed")
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


def test_hybrid_overlap_rmat_larger(stream_env):
    """A larger R-MAT through the whole hybrid on the card's window queue
    (device windows, W = 4, slices of 4096) at factor 1, the longest
    loop: equal to the reference under the same knobs and the oracle."""
    tail, head = rmat_edges(13, 8 << 13, seed=5)
    stream_env.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    stream_env.setenv("SHEEP_OVERLAP_SLICE", "4096")
    perf = {}
    got = PB.build_graph_hybrid(tail, head, handoff_factor=1, perf=perf,
                                device="cpu")
    assert perf["stream_mode"] == "windowed" and perf["rounds"] > 0, perf
    _same(got, RB.build_graph_hybrid(tail, head, handoff_factor=1))
    _same(got, _oracle(tail, head))


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
    stream_env.setenv("SHEEP_HANDOFF_WINDOWS", "3")
    stream_env.setenv("SHEEP_STREAM_HOST_SEQ", "0")
    assert PB.handoff_windows(10, cuda) == RB.handoff_windows(10) == 3
    assert PB.host_seq_mode(CPU) is RB.host_seq_mode() is False
    # the port has no speculative snapshot and reads none of its knobs:
    # where the reference's legacy overlap turns the stream off, the
    # port's stays on
    stream_env.delenv("SHEEP_STREAM_HANDOFF")
    stream_env.setenv("SHEEP_OVERLAP_HANDOFF", "1")
    assert PB.stream_handoff_enabled() is True
    assert RB.stream_handoff_enabled() is False
    stream_env.setenv("SHEEP_STREAM_HANDOFF", "0")
    assert PB.stream_handoff_enabled() is RB.stream_handoff_enabled() \
        is False


def _links(rng, n, live, pad):
    lo = np.full(pad, n, np.int64)
    hi = np.full(pad, n, np.int64)
    lo[:live] = rng.integers(0, n - 1, live)
    hi[:live] = rng.integers(0, n - 1, live)
    return lo, hi


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _drained(s) -> None:
    """The stream's thread has ended with every slice landed."""
    assert not s.join(timeout=60)
    assert s.done_slices == s.total_slices and not s.failed


@pytest.mark.parametrize("n", [1 << 20, (1 << 24) + 5])
def test_stream_fetcher_packed_and_pair_modes(stream_env, n):
    """A one-window stream delivers the exact table in the 6-byte-packed
    (n < 2^24) and int32-pair (n >= 2^24) modes, as the reference's
    fetcher does."""
    stream_env.setenv("SHEEP_PACK_HANDOFF", "1")
    rng = np.random.default_rng(94)
    live, pad = 9000, 1 << 14
    lo, hi = _links(rng, n, live, pad)
    f = PB._WindowStream(_t(lo), _t(hi), n, live, slice_links=2048,
                         windows=1)
    _drained(f)
    assert f.packed is (n < (1 << 24))
    got = f.window(0)
    keep = got[0] < n
    np.testing.assert_array_equal(got[0][keep], lo[:live])
    np.testing.assert_array_equal(got[1][keep], hi[:live])
    rf = RB._StreamFetcher(jnp.asarray(lo, jnp.int32),
                           jnp.asarray(hi, jnp.int32), n, live,
                           slice_links=2048)
    rf.join()
    want = rf.collect()
    if f.packed:  # the port's packed unpack drops the dead slots itself
        assert len(got[0]) == live
        want = tuple(w[want[0] < n] for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (f.slice_len, f.total_slices, f.packed) == \
        (rf.slice_len, rf.total_slices, rf.packed)


def test_stream_fetcher_non_pow2_slice_covers_all(stream_env):
    """A non-power-of-two SHEEP_OVERLAP_SLICE rounds down to a power of
    two, so slices tile the pow2 width and no tail link is dropped."""
    n, pad = 1 << 20, 1 << 14
    live = pad - 100
    lo, hi = _links(np.random.default_rng(96), n, live, pad)
    f = PB._WindowStream(_t(lo), _t(hi), n, live, slice_links=3000,
                         windows=1)
    assert f.slice_len == 2048
    _drained(f)
    got_lo, got_hi = f.window(0)
    keep = got_lo < n
    np.testing.assert_array_equal(got_lo[keep], lo[:live])
    np.testing.assert_array_equal(got_hi[keep], hi[:live])


def test_stream_fetcher_abort_keeps_prefix(stream_env):
    n, pad = 1 << 20, 1 << 14
    rng = np.random.default_rng(95)
    lo = rng.integers(0, n - 1, pad)
    hi = rng.integers(0, n - 1, pad)
    f = PB._WindowStream(_t(lo), _t(hi), n, pad, slice_links=1024,
                         windows=1)
    f.abort()  # immediately: whatever landed must be a prefix
    assert f.failed is False, "abort must not poison a healthy stream"
    assert not f._thread.is_alive()
    got_lo, got_hi = f.collect_range(0, f.done_slices)
    k = len(got_lo)
    assert k % 1024 == 0 and k == f.done_slices * 1024
    np.testing.assert_array_equal(got_lo, lo[:k])
    np.testing.assert_array_equal(got_hi, hi[:k])


def test_abort_slow_stream_does_not_poison(stream_env, monkeypatch):
    """abort() on a slow but healthy stream, whose slice is still in
    flight when the abort stops waiting, neither marks it failed nor
    loses the slices that landed; the thread ends at the next slice
    boundary."""
    n, pad, slice_links = 1 << 20, 1 << 14, 1024
    rng = np.random.default_rng(99)
    lo = rng.integers(0, n - 1, pad)
    hi = rng.integers(0, n - 1, pad)
    gate = threading.Event()
    real = PB._slice_rows

    def slow(buf, start, length):
        if start >= 2 * slice_links:  # the third slice waits on the gate
            gate.wait(timeout=60)
        return real(buf, start, length)

    monkeypatch.setattr(PB, "_slice_rows", slow)
    f = PB._WindowStream(_t(lo), _t(hi), n, pad, slice_links, windows=1)
    deadline = time.monotonic() + 60
    while f.done_slices < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    f.abort(timeout=0.05)
    assert f._thread.is_alive() and f.failed is False
    gate.set()
    assert not f.join(timeout=60)
    assert f.failed is False and f.done_slices == 3
    got_lo, got_hi = f.collect_range(0, f.done_slices)
    np.testing.assert_array_equal(got_lo, lo[:3 * slice_links])
    np.testing.assert_array_equal(got_hi, hi[:3 * slice_links])


@pytest.mark.parametrize("packed", [False, True])
def test_fetch_phases_count_every_slice(stream_env, packed):
    """A stream's breakdown (``fetch_phases``): every slice counted with
    the bytes it landed, its allocation, enqueue and wait within the
    slice's whole time, no device time on the CPU."""
    stream_env.setenv("SHEEP_PACK_HANDOFF", "1" if packed else "0")
    n, live, width = 1000, 5000, 8192
    rng = np.random.default_rng(7)
    lo = np.full(width, n, np.int32)
    hi = np.full(width, n, np.int32)
    lo[:live] = rng.integers(0, n - 1, live)
    hi[:live] = lo[:live] + 1
    f = PB._WindowStream(torch.from_numpy(lo), torch.from_numpy(hi), n,
                         live, 1024, windows=1)
    _drained(f)
    p = f.phases
    assert p["slices"] == f.total_slices == 5
    assert p["bytes"] == 5 * 1024 * (6 if packed else 8)
    assert p["device_ms"] == 0.0
    assert 0 <= p["alloc_s"] + p["copy_s"] + p["wait_s"] <= p["busy_s"]
    got_lo, got_hi = f.window(0)
    np.testing.assert_array_equal(got_lo[:live], lo[:live])
    np.testing.assert_array_equal(got_hi[:live], hi[:live])


#: (live, width, slice, W, packed): live under one slice, none live,
#: live an exact multiple of the slice, W above the slice count, a
#: slice equal to and one past the width, an uneven cut, a slice
#: below the 512 floor
CUT_CASES = [(100, 4096, 1024, 4, False), (0, 4096, 1024, 4, False),
             (4096, 8192, 1024, 4, False), (3000, 4096, 1024, 8, True),
             (4000, 4096, 4096, 2, False), (4000, 4096, 1 << 14, 2, True),
             (5 * 1024, 8192, 1024, 3, True), (2000, 4096, 100, 2, False)]


@pytest.mark.parametrize("live, width, slice_links, w, packed", CUT_CASES)
def test_window_cuts_equal_reference(stream_env, live, width, slice_links,
                                     w, packed):
    """The window cut rule against the reference's ``_WindowStream`` on
    the same table: the same slice length, slice count, window count and
    cuts, and each window's host links equal (the reference's with its
    dead slots dropped where the port's packed unpack drops them)."""
    stream_env.setenv("SHEEP_PACK_HANDOFF", "1" if packed else "0")
    n = 1 << 16
    lo, hi = _links(np.random.default_rng(live + w), n, live, width)
    hi[:live] = np.sort(hi[:live])  # the stream takes a hi-sorted table
    f = PB._WindowStream(_t(lo), _t(hi), n, live, slice_links, w)
    rf = RB._WindowStream(jnp.asarray(lo, jnp.int32),
                          jnp.asarray(hi, jnp.int32), n, live, slice_links,
                          w)
    assert (f.slice_len, f.total_slices, f.windows, f._cuts, f.packed) == \
        (rf.slice_len, rf.total_slices, rf.windows, rf._cuts, rf.packed)
    for k in range(f.windows):
        got = f.window(k, timeout_s=60)
        want = rf.window(k, timeout_s=60)
        if packed:
            want = tuple(x[want[0] < n] for x in want)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
    _drained(f)
    assert not rf.join(timeout=60)


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


UNPACK_ARMS = {
    "stream": {"SHEEP_STREAM_DEVICE_WINDOWS": "1",
               "SHEEP_HANDOFF_WINDOWS": "4", "SHEEP_OVERLAP_SLICE": "2048"},
    "serial": {"SHEEP_STREAM_HANDOFF": "0"},
    # one window of the smallest slices: the most slices a window unpacks
    "stream1": {"SHEEP_STREAM_DEVICE_WINDOWS": "1",
                "SHEEP_HANDOFF_WINDOWS": "1", "SHEEP_OVERLAP_SLICE": "512"},
}


@pytest.mark.parametrize("arm", sorted(UNPACK_ARMS))
def test_packed_handoff_unpack(stream_env, arm):
    """Every packed handoff unpacks through ``unpack_handoff``: each
    unpack's span (``handoff.unpack``, or ``handoff.fetch`` on the serial
    fetch) counts the dead slots it dropped, and the forest equals the
    reference's and the oracle's."""
    n, tail, head = _graph()
    stream_env.setenv("SHEEP_PACK_HANDOFF", "1")
    for k, v in UNPACK_ARMS[arm].items():
        stream_env.setenv(k, v)
    perf = {}
    with obs.capture() as cap:
        got = PB.build_graph_hybrid(tail, head, n, handoff_factor=1,
                                    perf=perf, device="cpu")
    assert perf["packed_handoff"] is True
    unpacks = cap.named("handoff.unpack") + cap.named("handoff.fetch")
    assert unpacks
    for sp in unpacks:
        assert sp.attrs["dead"] >= 0, sp.attrs
    if arm != "serial":
        assert perf["stream_mode"] == "windowed"
        if arm == "stream1":
            assert perf["fetch_windows"] == 1
        slots = sum(sp.attrs["links"] for sp in cap.named("handoff.slice"))
        links = cap.named("handoff.unpack")
        assert sum(sp.attrs["links"] for sp in links) \
            == perf["handoff_links"]
        assert sum(sp.attrs["dead"] for sp in links) \
            == slots - perf["handoff_links"] > 0
    _same(got, RB.build_graph_hybrid(tail, head, n, handoff_factor=1))
    _same(got, _oracle(tail, head))
