"""The port's speculative overlapped handoff (sheep_tpu_torch/ops/build.py:
_SpecHandoff, reduce_and_fetch_links, and reduce_links_hosted's ``watch``
hook) equals sheep_tpu's (JAX on the CPU) and the host oracle exactly.

The speculation is on by default on CUDA only; here it is forced on with
the reference's knobs (SHEEP_OVERLAP_HANDOFF=1, tiny slices and floor),
as tests/test_overlap_handoff.py forces it, and both packages run under
the same environment.  Every outcome of ``complete`` (plain,
spec_complete, spec_wait, restart_final, spec_wait_timeout) is driven in
both packages on the same fetchers and snapshots.  The snapshot handed to
``watch`` must still equal, at the loop's end, a clone taken when it was
handed out.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sheep_tpu.ops.build as RB
from sheep_tpu.core import build_forest, degree_sequence
from sheep_tpu.ops.forest import reduce_links_hosted as ref_reduce

import sheep_tpu_torch.ops.build as PB
from sheep_tpu_torch.ops.forest import reduce_links_hosted
from sheep_tpu_torch.utils import rmat_edges

CPU = torch.device("cpu")


def _oracle(tail, head):
    seq = degree_sequence(tail, head)
    return seq, build_forest(tail, head, seq)


def _graph(seed=90, n=400, e=6000):
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    return tail, head


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].parent, want[1].parent)
    np.testing.assert_array_equal(got[1].pst_weight, want[1].pst_weight)


@pytest.fixture
def overlap_env(monkeypatch):
    """tests/test_overlap_handoff.py's knobs, for both packages."""
    monkeypatch.setenv("SHEEP_OVERLAP_HANDOFF", "1")
    monkeypatch.setenv("SHEEP_OVERLAP_MIN_MB", "0.0001")
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", "4096")
    for k in ("SHEEP_HANDOFF_FACTOR", "SHEEP_STREAM_HANDOFF",
              "SHEEP_OVERLAP_SPEC_FACTOR", "SHEEP_PACK_HANDOFF"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _hybrid_both(tail, head, **kw):
    """The port's and the reference's hybrid on the same input; the
    port's perf dict beside them."""
    perf = {}
    got = PB.build_graph_hybrid(tail, head, perf=perf, device="cpu", **kw)
    want = RB.build_graph_hybrid(tail, head, **kw)
    return got, want, perf


def test_hybrid_overlap_oracle_exact(overlap_env):
    tail, head = _graph()
    got, want, perf = _hybrid_both(tail, head, handoff_factor=2)
    assert perf["overlap"] is True and perf["fetch_windows"] == 0, perf
    _same(got, want)
    _same(got, _oracle(tail, head))


def test_hybrid_overlap_matches_overlap_off(overlap_env):
    tail, head = _graph(seed=91)
    on = PB.build_graph_hybrid(tail, head, handoff_factor=2, device="cpu")
    overlap_env.setenv("SHEEP_OVERLAP_HANDOFF", "0")
    perf = {}
    off = PB.build_graph_hybrid(tail, head, handoff_factor=2, perf=perf,
                                device="cpu")
    assert "spec_mode" not in perf
    _same(on, off)
    _same(on, RB.build_graph_hybrid(tail, head, handoff_factor=2))


def _prepared(seed, n, e):
    """The port's and the reference's prepare_links on one graph."""
    tail, head = _graph(seed=seed, n=n, e=e)
    port = PB.prepare_links(torch.from_numpy(tail.astype(np.int32)),
                            torch.from_numpy(head.astype(np.int32)), n)
    ref = RB.prepare_links(jnp.asarray(tail, jnp.int32),
                           jnp.asarray(head, jnp.int32), n)
    return tail, head, port, ref


def _forest_of(kind, a, b, live, n, pst, fetch):
    if kind == "device":  # converged before the threshold
        a, b, _ = fetch(a, b, live, n)
    return PB.finish_native_host(np.asarray(a), np.asarray(b), n,
                                 np.asarray(pst).astype(np.uint32)[:n])


def test_reduce_and_fetch_spec_runs_and_is_exact(overlap_env):
    """reduce_and_fetch_links with the speculation engaged (spec_starts
    >= 1): its handoff set folds into the reference's forest and the
    oracle's."""
    overlap_env.setenv("SHEEP_OVERLAP_SPEC_FACTOR", "1000")
    n = 1 << 10
    tail, head, port, ref = _prepared(92, n, 1 << 14)
    perf = {}
    kind, a, b, live, _ = PB.reduce_and_fetch_links(port[3], port[4], n,
                                                    stop_live=n, perf=perf)
    assert perf.get("spec_starts", 0) >= 1, perf
    assert perf["spec_fetch_phases"]["slices"] >= 1, perf
    assert perf["spec_mode"] in ("spec_complete", "spec_wait",
                                 "restart_final", "plain"), perf
    assert "loop_s" in perf and "fetch_tail_s" in perf
    parent, pst = _forest_of(kind, a, b, live, n, port[5],
                             PB.fetch_links_host)
    rkind, ra, rb, rlive, _ = RB.reduce_and_fetch_links(ref[3], ref[4], n,
                                                        stop_live=n)
    rparent, rpst = _forest_of(rkind, ra, rb, rlive, n, ref[5],
                               RB.fetch_links_host)
    m = int(port[2])
    np.testing.assert_array_equal(parent[:m], rparent[:m])
    np.testing.assert_array_equal(pst[:m], rpst[:m])
    _, want = _oracle(tail, head)
    np.testing.assert_array_equal(parent[:m], want.parent)
    np.testing.assert_array_equal(pst[:m], want.pst_weight)
    if kind == "host":
        assert perf["handoff_links"] == len(a)


def test_union_of_snapshots_is_sound(overlap_env):
    """An early snapshot from ``watch`` unioned with the final links folds
    into the oracle's forest, and the port's snapshots equal the
    reference's, one for one."""
    n = 512
    tail, head, port, ref = _prepared(93, n, 1 << 13)
    snaps, ref_snaps = [], []

    def watch(slo, shi, live):
        snaps.append((slo.numpy().copy(), shi.numpy().copy(), int(live)))
        return False

    def ref_watch(slo, shi, live):
        ref_snaps.append((np.asarray(slo), np.asarray(shi), int(live)))
        return False

    lo2, hi2, live2, _, _ = reduce_links_hosted(port[3], port[4], n,
                                                stop_live=n, watch=watch)
    ref_reduce(ref[3], ref[4], n, stop_live=n, watch=ref_watch)
    assert snaps, "watch hook never fired"
    assert len(snaps) == len(ref_snaps)
    for (a, b, live), (ra, rb, rlive) in zip(snaps, ref_snaps):
        assert live == rlive
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(b, rb)
    early_lo, early_hi, early_live = snaps[0]
    mix_lo = np.concatenate([early_lo[:early_live],
                             lo2.numpy()[:int(live2)]])
    mix_hi = np.concatenate([early_hi[:early_live],
                             hi2.numpy()[:int(live2)]])
    keep = mix_lo < n
    parent, pst = PB.finish_native_host(
        mix_lo[keep], mix_hi[keep], n, port[5].numpy().astype(np.uint32))
    _, want = _oracle(tail, head)
    m = int(port[2])
    np.testing.assert_array_equal(parent[:m], want.parent)
    np.testing.assert_array_equal(pst[:m], want.pst_weight)


@pytest.mark.parametrize("stop", [False, True])
def test_watch_snapshot_is_never_written(overlap_env, stop):
    """Every snapshot handed to ``watch`` is, at the loop's end,
    bit-identical to a clone taken when it was handed out (the loop, the
    compaction, the remap, the host assists and the descent write only
    into tensors they allocate).  With ``stop`` the hook ends the loop at
    its second call, which returns that very snapshot."""
    n = 1 << 12
    tail, head = rmat_edges(12, 8 << 12, seed=4)
    port = PB.prepare_links(torch.from_numpy(tail.astype(np.int32)),
                            torch.from_numpy(head.astype(np.int32)), n)
    handed = []

    def watch(slo, shi, live):
        handed.append((slo, shi, slo.clone(), shi.clone()))
        return stop and len(handed) == 2

    lo, hi, _, _, converged = reduce_links_hosted(port[3], port[4], n,
                                                  watch=watch)
    assert len(handed) >= 2
    for slo, shi, clo, chi in handed:
        assert torch.equal(slo, clo) and torch.equal(shi, chi)
    if stop:
        assert not converged and lo is handed[1][0] and hi is handed[1][1]


class _FakeFetcher:
    """The reference test's fetcher double: a remainder, landed slices and
    a partial (lo, hi)."""

    def __init__(self, remaining, done=1, collect=None):
        self._remaining = remaining
        self.done_slices = done
        self.failed = False
        self._collect = collect or (np.zeros(10, np.int32),
                                    np.ones(10, np.int32))

    def finished(self):
        return self._remaining == 0

    def remaining_bytes(self):
        return self._remaining

    def abort(self, timeout=5.0):
        pass

    def join(self, timeout=None, mark_failed=True):
        self._remaining = 0
        return False

    def fetched_bytes(self):
        return 6 * 1000

    def collect(self):
        return self._collect


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_spec_handoff_restart_policy(impl):
    """The abandon/restart rule, unit-level and the same in both
    packages: a fetch whose remainder exceeds MARGIN times the fresh
    snapshot restarts (above the floor only); a finished one stops the
    loop."""
    n = 1 << 16
    sp = PB._SpecHandoff(n, CPU) if impl == "port" else RB._SpecHandoff(n)
    assert sp.MARGIN == 1.25
    started = []
    sp._start = lambda lo, hi, live: started.append(live)
    big_live = 2 * sp.min_bytes // sp.bpl
    sp.active = _FakeFetcher(remaining=100 * sp.min_bytes)
    assert sp.on_chunk(None, None, big_live) is False
    assert sp.stats["spec_restarts"] == 1 and started == [big_live]
    assert len(sp.kept) == 1
    sp.active = _FakeFetcher(remaining=10_000_000)
    assert sp.on_chunk(None, None, 1000) is False
    assert sp.stats["spec_restarts"] == 2 and started == [big_live]
    sp.active = _FakeFetcher(remaining=0)
    assert sp.on_chunk(None, None, 500) is True
    assert sp.stats["spec_stopped_loop"] is True
    # two abandons of 6000 bytes, each added and rounded to 0.01 MB
    assert sp.stats["spec_wasted_mb"] == 0.02


def test_spec_knobs_and_defaults(overlap_env):
    """The knobs' defaults and meanings equal the reference's."""
    for k in ("SHEEP_OVERLAP_MIN_MB", "SHEEP_OVERLAP_SLICE"):
        overlap_env.delenv(k)
    for n in (1000, (1 << 24) + 5):
        sp, ref = PB._SpecHandoff(n, CPU), RB._SpecHandoff(n)
        assert (sp.bpl, sp.spec_live, sp.slice_links, sp.min_bytes) \
            == (ref.bpl, ref.spec_live, ref.slice_links, ref.min_bytes) \
            == (8, 8 * n, 1 << 18, 4 << 20)
        assert sp.stats == ref.stats
    overlap_env.setenv("SHEEP_OVERLAP_SPEC_FACTOR", "3")
    overlap_env.setenv("SHEEP_OVERLAP_SLICE", "777")
    overlap_env.setenv("SHEEP_OVERLAP_MIN_MB", "0.5")
    overlap_env.setenv("SHEEP_PACK_HANDOFF", "1")
    sp, ref = PB._SpecHandoff(1000, CPU), RB._SpecHandoff(1000)
    assert (sp.bpl, sp.spec_live, sp.slice_links, sp.min_bytes) \
        == (ref.bpl, ref.spec_live, ref.slice_links, ref.min_bytes) \
        == (6, 3000, 777, 1 << 19)
    # the packing policy follows the card on CUDA, as the reference's
    # accelerator default
    overlap_env.delenv("SHEEP_PACK_HANDOFF")
    assert PB._SpecHandoff(1000, torch.device("cuda")).bpl == 6


def _final_links(n, live, pad, seed):
    rng = np.random.default_rng(seed)
    lo = np.full(pad, n, np.int64)
    hi = np.full(pad, n, np.int64)
    lo[:live] = rng.integers(0, n - 1, live)
    hi[:live] = np.minimum(lo[:live] + 1 + rng.integers(0, 9, live), n - 1)
    return lo, hi


class _WedgedFetcher(_FakeFetcher):
    """A stream whose wait never ends: the join watchdog fires."""

    def finished(self):
        return False

    def remaining_bytes(self):
        return 1  # a tiny remainder: complete() takes the wait path

    def join(self, timeout=None, mark_failed=True):
        if mark_failed:
            self.failed = True
        return True

    def fetched_bytes(self):
        return 3 << 20

    def collect(self):
        raise AssertionError("collect must not run on a wedged stream")


def _outcome_fetcher(mode, partial):
    if mode == "spec_complete":
        return _FakeFetcher(0, collect=partial)
    if mode == "spec_wait":
        return _FakeFetcher(1, collect=partial)
    if mode == "restart_final":
        return _FakeFetcher(1 << 40, collect=partial)
    if mode == "spec_wait_timeout":
        return _WedgedFetcher(1)
    return None  # "plain": no stream was ever started


@pytest.mark.parametrize("mode", ["plain", "spec_complete", "spec_wait",
                                  "restart_final", "spec_wait_timeout"])
def test_complete_every_outcome_equals_reference(overlap_env, mode):
    """``complete`` through each of its outcomes, on the same final
    snapshot, the same stream double and the same kept partial in both
    packages: the same mode, the same stats and the same host link arrays
    (filtered, in order)."""
    n = 1 << 12
    lo, hi = _final_links(n, 6000, 1 << 13, 97)
    early = _final_links(n, 900, 1024, 98)
    partial = (early[0][:1024].astype(np.int32),
               early[1][:1024].astype(np.int32))
    kept = (early[0][:300].astype(np.int32), early[1][:300].astype(np.int32))
    outs = {}
    for impl in ("port", "reference"):
        if impl == "port":
            sp = PB._SpecHandoff(n, CPU)
            args = (torch.from_numpy(lo.astype(np.int32)),
                    torch.from_numpy(hi.astype(np.int32)))
        else:
            sp = RB._SpecHandoff(n)
            args = (jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32))
        sp.kept = [kept]
        sp.active = _outcome_fetcher(mode, partial)
        got = sp.complete(*args, 6000)
        outs[impl] = (got, dict(sp.stats))
    (plo, phi), pstats = outs["port"]
    (rlo, rhi), rstats = outs["reference"]
    assert pstats["spec_mode"] == rstats["spec_mode"] == mode
    assert pstats == rstats
    np.testing.assert_array_equal(plo, rlo)
    np.testing.assert_array_equal(phi, rhi)
    assert (plo < n).all() and len(plo) == len(phi)
    if mode == "spec_wait_timeout":
        assert pstats["spec_wasted_mb"] >= 3.0


def test_spec_wait_timeout_falls_back_serial(overlap_env):
    """A wedged stream falls back to the serial fetch, records
    spec_wait_timeout, counts the wasted bytes, and still hands off the
    exact link multiset."""
    n = 1 << 12
    lo_np, hi_np = _final_links(n, 6000, 1 << 13, 97)
    sp = PB._SpecHandoff(n, CPU)
    sp.active = _WedgedFetcher(1)
    lo_h, hi_h = sp.complete(torch.from_numpy(lo_np.astype(np.int32)),
                             torch.from_numpy(hi_np.astype(np.int32)), 6000)
    assert sp.stats["spec_mode"] == "spec_wait_timeout"
    assert sp.stats["spec_wasted_mb"] >= 3.0
    got = np.lexsort((hi_h, lo_h))
    want = np.lexsort((hi_np[:6000], lo_np[:6000]))
    np.testing.assert_array_equal(lo_h[got], lo_np[:6000][want])
    np.testing.assert_array_equal(hi_h[got], hi_np[:6000][want])


def test_abort_slow_stream_does_not_poison(overlap_env):
    """abort() on a slow but healthy stream neither marks it failed nor
    disables later speculation, and its landed slices are kept."""

    class SlowFetcher(_FakeFetcher):
        def join(self, timeout=None, mark_failed=True):
            return True  # still draining; abort passes mark_failed=False

        def abort(self, timeout=5.0):
            self.join(timeout, mark_failed=False)

        def fetched_bytes(self):
            return 2 << 20

    sp = PB._SpecHandoff(1 << 16, CPU)
    sp.active = SlowFetcher(1, done=2, collect=(np.zeros(100, np.int32),
                                                np.ones(100, np.int32)))
    sp._abandon()
    assert sp.dead is False, "a slow abort must not disable speculation"
    assert len(sp.kept) == 1 and sp.stats["spec_wasted_mb"] == 2.0


def test_overlap_disabled_on_cpu_by_default(monkeypatch):
    """Off on the CPU, on for CUDA, as the reference's platform default;
    SHEEP_OVERLAP_HANDOFF overrides both."""
    monkeypatch.delenv("SHEEP_OVERLAP_HANDOFF", raising=False)
    cuda = torch.device("cuda")
    assert PB._overlap_enabled(CPU) is RB._overlap_enabled() is False
    assert PB._overlap_enabled(cuda) is True
    assert PB._SpecHandoff.maybe(100, CPU) is None
    monkeypatch.setenv("SHEEP_OVERLAP_HANDOFF", "1")
    assert isinstance(PB._SpecHandoff.maybe(100, CPU), PB._SpecHandoff)
    monkeypatch.setenv("SHEEP_OVERLAP_HANDOFF", "0")
    assert PB._SpecHandoff.maybe(100, cuda) is None


def test_hybrid_overlap_rmat_larger(overlap_env):
    """A larger R-MAT through the whole hybrid with the speculation forced,
    many slices, factor 1 (the longest loop, the most chances to
    restart)."""
    tail, head = rmat_edges(13, 8 << 13, seed=5)
    got, want, perf = _hybrid_both(tail, head, handoff_factor=1)
    assert perf["spec_starts"] >= 1, perf
    _same(got, want)
    _same(got, _oracle(tail, head))


def test_hybrid_overlap_pair_mode_large_n(overlap_env):
    """The hybrid at n >= 2^24 (sparse edges over a huge vertex space):
    no 6-byte packing past 2^24, and the result stays exact.  (Here the
    input is already under the threshold, so the CPU hands it off at once
    and no stream starts; the stream's pair mode itself is
    test_torch_stream_handoff's fetcher test.)"""
    n = (1 << 24) + 1000
    e = 60_000
    rng = np.random.default_rng(98)
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    overlap_env.setenv("SHEEP_OVERLAP_SPEC_FACTOR", "100000")
    overlap_env.setenv("SHEEP_PACK_HANDOFF", "1")  # still pairs past 2^24
    got, want, perf = _hybrid_both(tail, head, num_vertices=n,
                                   handoff_factor=1)
    assert perf["spec_mode"] == "plain" and perf["packed_handoff"] is False
    _same(got, want)
    _same(got, _oracle(tail, head))


@pytest.mark.parametrize("packed", [False, True])
def test_fetch_phases_count_every_slice(monkeypatch, packed):
    """A stream's breakdown (``fetch_phases``): every slice counted with
    the bytes it landed, its allocation, enqueue and wait within the
    slice's whole time, no device time on the CPU; ``merge_phases`` sums
    several."""
    monkeypatch.setenv("SHEEP_PACK_HANDOFF", "1" if packed else "0")
    n, live, width = 1000, 5000, 8192
    rng = np.random.default_rng(7)
    lo = np.full(width, n, np.int32)
    hi = np.full(width, n, np.int32)
    lo[:live] = rng.integers(0, n - 1, live)
    hi[:live] = lo[:live] + 1
    f = PB._StreamFetcher(torch.from_numpy(lo), torch.from_numpy(hi), n,
                          live, 1024)
    assert not f.join(timeout=60) and f.finished()
    p = f.phases
    assert p["slices"] == f.total_slices == 5
    assert p["bytes"] == 5 * 1024 * (6 if packed else 8)
    assert p["device_ms"] == 0.0
    assert 0 <= p["alloc_s"] + p["copy_s"] + p["wait_s"] <= p["busy_s"]
    got_lo, got_hi = f.collect()
    np.testing.assert_array_equal(got_lo[:live], lo[:live])
    np.testing.assert_array_equal(got_hi[:live], hi[:live])
    both = PB.merge_phases([p, p])
    assert both["slices"] == 10 and both["bytes"] == 2 * p["bytes"]
    assert both["busy_s"] == round(2 * p["busy_s"], 4)
