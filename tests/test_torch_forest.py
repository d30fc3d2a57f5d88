"""The port's reduce loop (sheep_tpu_torch/ops/forest.py) equals
sheep_tpu's ops/forest.py (JAX on the CPU) exactly: every round piece,
the chunk functions, the plateau assist, the vertex remap and
reduce_links_hosted with its knobs.  Arrays are compared whole, dead
slots included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_multigraph

import sheep_tpu.ops.forest as R
import sheep_tpu_torch.ops.forest as P
from sheep_tpu.core import build_forest, degree_sequence
from sheep_tpu.ops.build import prepare_links as ref_prepare_links
from sheep_tpu_torch.utils import rmat_edges


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        assert got.dtype in (torch.int32, torch.uint8), got.dtype
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _links(tail, head, n):
    """Prep-time links of a graph, as numpy (the reference's prep; the
    port's prep is held equal to it in test_torch_build)."""
    _, _, _, lo, hi, _ = ref_prepare_links(
        jnp.asarray(tail, jnp.int32), jnp.asarray(head, jnp.int32), n)
    return np.asarray(lo), np.asarray(hi)


def _graph_links(seed, n_max=300, e_max=3000):
    rng = np.random.default_rng(seed)
    tail, head = random_multigraph(rng, n_max, e_max)
    n = int(max(tail.max(), head.max())) + 1
    lo, hi = _links(tail, head, n)
    return tail, head, n, lo, hi


def _random_links(seed, n, e, dead_frac=0.2):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n, e)
    hi = np.minimum(lo + rng.integers(1, n, e), n)
    dead = rng.random(e) < dead_frac
    lo[dead] = n
    hi[dead] = n
    return lo.astype(np.int32), hi.astype(np.int32)


# --- round pieces -----------------------------------------------------------

@pytest.mark.parametrize("n", [100, (1 << 22) + 3])
def test_sort_links_and_by_hi(n):
    lo, hi = _random_links(77, n, 5000)
    for pf, rf in ((P.sort_links, R.sort_links),
                   (P.sort_links_by_hi, R.sort_links_by_hi)):
        a, b = pf(_t(lo), _t(hi))
        ra, rb = rf(jnp.asarray(lo), jnp.asarray(hi))
        _eq(a, ra)
        _eq(b, rb)


@pytest.mark.parametrize("seed", range(3))
def test_rewrite_sorted(seed):
    lo, hi = _random_links(100 + seed, 500, 4000)
    slo, shi = R.sort_links(jnp.asarray(lo), jnp.asarray(hi))
    a, b, applied = P._rewrite_sorted(_t(slo), _t(shi), 500)
    ra, rb, rapplied = R._rewrite_sorted(slo, shi, 500)
    _eq(a, ra)
    _eq(b, rb)
    assert applied.dtype == torch.int32 and int(applied) == int(rapplied)


def test_min_up_table_parent_and_pst():
    lo, hi = _random_links(5, 50, 200)
    _eq(P.min_up_table(_t(lo), _t(hi), 50), R.min_up_table(lo, hi, 50))
    _eq(P.parent_from_links(_t(lo), _t(hi), 50),
        R.parent_from_links(jnp.asarray(lo), jnp.asarray(hi), 50))
    _eq(P.pst_weights(_t(lo), 50), R.pst_weights(jnp.asarray(lo), 50))


@pytest.mark.parametrize("levels", range(1, 17))
def test_jump_levels(levels):
    lo, hi = _random_links(200 + levels, 3000, 20000)
    got_lo, got_moved = P._jump(_t(lo), _t(hi), 3000, levels)
    want_lo, want_moved = R._jump(jnp.asarray(lo), jnp.asarray(hi), 3000,
                                  levels)
    _eq(got_lo, want_lo)
    assert got_moved.dtype == torch.int32
    assert int(got_moved) == int(want_moved)


def test_pack_links_6b_roundtrip():
    rng = np.random.default_rng(962)
    lo = rng.integers(0, (1 << 24) - 1, 5000).astype(np.int32)
    hi = rng.integers(0, (1 << 24) - 1, 5000).astype(np.int32)
    buf = P.pack_links_6b(_t(lo), _t(hi))
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == (5000, 6)
    _eq(buf, R.pack_links_6b(jnp.asarray(lo), jnp.asarray(hi)))
    lo2, hi2 = P.unpack_links_6b(buf.numpy())
    np.testing.assert_array_equal(lo2, lo)
    np.testing.assert_array_equal(hi2, hi)


@pytest.mark.parametrize("x", [0, 1, 4095, 4096, 4097, 1 << 20, 3 << 20])
def test_pad_and_gate_helpers(x):
    assert P._pad_pow2(x) == R._pad_pow2(x)
    assert P._pad_pow2_min(x) == R._pad_pow2_min(x)
    for pad in (4096, 1 << 17, 1 << 20, 1 << 22):
        assert P._pipe_width_ok(x, pad) == R._pipe_width_ok(x, pad)


def test_depth_tier_rule():
    for pad in (4096, 1 << 16, 1 << 20):
        for size in (100, pad // 8, pad // 8 + 1, pad // 2, pad):
            for sched in (False, True):
                for cap in (9, 22, 30):
                    args = (size, pad, sched, 10, 4, cap)
                    assert P._depth_tier(*args) == R._depth_tier(*args)
    assert P._CHUNK_SCHEDULE == R._CHUNK_SCHEDULE


# --- chunk functions --------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 4, 10])
def test_jump_chunk(levels):
    _, _, n, lo, hi = _graph_links(300 + levels)
    a, b, stats = P.jump_chunk(_t(lo), _t(hi), n, levels)
    ra, rb, rstats = R.jump_chunk(jnp.asarray(lo), jnp.asarray(hi), n, levels)
    _eq(a, ra)
    _eq(b, rb)
    _eq(stats, rstats)


@pytest.mark.parametrize("levels,jrounds", [(1, 1), (4, 2), (10, 3), (16, 8)])
def test_fixpoint_chunk(levels, jrounds):
    _, _, n, lo, hi = _graph_links(310 + levels)
    a, b, stats = P.fixpoint_chunk(_t(lo), _t(hi), n, levels, jrounds)
    ra, rb, rstats = R.fixpoint_chunk(jnp.asarray(lo), jnp.asarray(hi), n,
                                      levels, jrounds)
    _eq(a, ra)
    _eq(b, rb)
    _eq(stats, rstats)


# --- vertex remap -----------------------------------------------------------

def test_vremap_compact_back_and_composition():
    rng = np.random.default_rng(41)
    n = 1 << 18
    verts = np.sort(rng.choice(n - 1, size=600, replace=False))
    lo = verts[rng.integers(0, 500, 2048)].astype(np.int32)
    hi = (lo + 1 + rng.integers(0, 50, 2048)).astype(np.int32)
    dead = rng.random(2048) < 0.3
    lo[dead] = n
    hi[dead] = n
    nc1 = 2 * len(lo)
    lo1, hi1, back1 = P.vremap_compact(_t(lo), _t(hi), n, nc1)
    rlo1, rhi1, rback1 = R.vremap_compact(jnp.asarray(lo), jnp.asarray(hi),
                                          n, nc1)
    _eq(lo1, rlo1)
    _eq(hi1, rhi1)
    _eq(back1, rback1)
    rlo, rhi = P.vremap_back(lo1, hi1, back1)
    np.testing.assert_array_equal(rlo.numpy(), lo)
    np.testing.assert_array_equal(rhi.numpy(), hi)
    nc2 = 1 << 12
    lo2, hi2, back2 = P.vremap_compact(lo1, hi1, nc1, nc2)
    rlo2, rhi2, rback2 = R.vremap_compact(rlo1, rhi1, nc1, nc2)
    _eq(lo2, rlo2)
    _eq(back2, rback2)
    total = torch.index_select(back1, 0, back2)
    blo, bhi = P.vremap_back(lo2, hi2, total)
    np.testing.assert_array_equal(blo.numpy(), lo)
    np.testing.assert_array_equal(bhi.numpy(), hi)


def test_vremap_drops_ranks_beyond_nc():
    # nc smaller than the distinct endpoints: the reference drops the
    # overflowing back writes (mode="drop"); so must the port
    lo = np.array([0, 2, 4, 6, 9], np.int32)
    hi = np.array([1, 3, 5, 7, 9], np.int32)
    for nc in (3, 4, 8):
        got = P.vremap_compact(_t(lo), _t(hi), 9, nc)
        want = R.vremap_compact(jnp.asarray(lo), jnp.asarray(hi), 9, nc)
        _eq(got[2], want[2])


# --- plateau assist ---------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 1, 50])
@pytest.mark.parametrize("seed", range(3))
def test_plateau_assist_walk(seed, cap):
    lo, hi = _random_links(400 + seed, 400, 1500)
    n = 400
    f = np.asarray(R.min_up_table(lo, hi, n)).astype(np.int64)
    out = []
    for walk in (P.plateau_assist_walk, R.plateau_assist_walk):
        l, h, ff = lo.astype(np.int64), hi.astype(np.int64), f.copy()
        res = walk(l, h, ff, n, cap=cap)
        out.append((res, l, ff))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][2], out[1][2])


def test_scatter_lo_drops_padding():
    lo = np.arange(40, dtype=np.int32)
    idx = np.array([3, 7, 40, 40], np.int32)  # 40 == len(lo): dropped
    vals = np.array([30, 31, 99, 98], np.int32)
    got = P._scatter_lo(_t(lo), _t(idx), _t(vals), 4)
    want = R._scatter_lo(jnp.asarray(lo), jnp.asarray(idx),
                         jnp.asarray(vals), 4)
    _eq(got, want)
    np.testing.assert_array_equal(_t(lo).numpy(), lo)  # input untouched


@pytest.mark.parametrize("seq_stats", [
    [(10**6, 1000), (10**6, 950)],
    [(10**6, 1000), (10**6, 951)],
    [(126, 1000)], [(125, 1000)], [(0, 1000)],
    [(10**6, 10**6), (5, 10**6), (10**6, 10)],
])
def test_plateau_detector_matches_reference(seq_stats):
    p, r = P._PlateauSched(), R._PlateauSched()
    for s in (p, r):
        s.enabled, s.on = True, False
    for moved, live in seq_stats:
        p.observe(moved, live)
        r.observe(moved, live)
        assert p.on == r.on
    for moved in (0, 1, 500, p.cap, p.cap + 1):
        assert p.wants_assist(moved) == r.wants_assist(moved)
    p.bail = r.bail = 1000
    for moved in (499, 500, 501):
        assert p.wants_assist(moved) == r.wants_assist(moved)


# --- reduce_links_hosted ----------------------------------------------------

def _reduce_both(lo, hi, n, **kw):
    got = P.reduce_links_hosted(_t(lo), _t(hi), n, **kw)
    want = R.reduce_links_hosted(jnp.asarray(lo), jnp.asarray(hi), n, **kw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert tuple(got[2:]) == tuple(int(x) if not isinstance(x, bool) else x
                                   for x in want[2:]), (got[2:], want[2:])
    return got


@pytest.mark.parametrize("handoff_input", [False, True])
@pytest.mark.parametrize("factor", [0, 3, 8])
def test_reduce_links_hosted(factor, handoff_input):
    _, _, n, lo, hi = _graph_links(500 + factor, 400, 6000)
    _reduce_both(lo, hi, n, stop_live=factor * n,
                 handoff_input=handoff_input)


@pytest.mark.parametrize("env", [
    {"SHEEP_PLATEAU_FORCE": "1"},
    {"SHEEP_PLATEAU_FORCE": "1", "SHEEP_PLATEAU_ASSIST_CAP": "1"},
    {"SHEEP_PLATEAU_ADAPT": "0"},
    {"SHEEP_VREMAP": "0"},
    {"SHEEP_PIPELINE_CHUNKS": "1"},
    {"SHEEP_PIPELINE_CHUNKS": "0"},
])
@pytest.mark.parametrize("seed", range(2))
def test_reduce_links_hosted_knobs(monkeypatch, env, seed):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, _, n, lo, hi = _graph_links(600 + seed, 400, 6000)
    for stop in (0, 2 * n):
        _reduce_both(lo, hi, n, stop_live=stop)


def _sparse_remap_links(seed, n=1 << 17):
    """Chains among ~1500 scattered positions: sparse, needs several
    chunks, and the width pads to the 4096 floor, so the remap fires."""
    rng = np.random.default_rng(1300 + seed)
    verts = np.sort(rng.choice(n - 1, size=1500, replace=False))
    idx = rng.integers(0, 1400, 3000)
    lo = verts[idx].astype(np.int32)
    hi = verts[idx + 1 + rng.integers(0, 90, 3000)].astype(np.int32)
    bad = lo >= hi
    lo[bad] = n
    hi[bad] = n
    return n, lo, hi


def _count_remaps(monkeypatch):
    calls = {"remaps": 0}
    real = P.vremap_compact

    def counting(*a, **k):
        calls["remaps"] += 1
        return real(*a, **k)

    monkeypatch.setattr(P, "vremap_compact", counting)
    return calls


@pytest.mark.parametrize("pipeline", ["0", "1"])
@pytest.mark.parametrize("seed", range(2))
def test_reduce_sparse_remap(monkeypatch, seed, pipeline):
    monkeypatch.setenv("SHEEP_PIPELINE_CHUNKS", pipeline)
    calls = _count_remaps(monkeypatch)
    n, lo, hi = _sparse_remap_links(seed)
    _reduce_both(lo, hi, n)
    assert calls["remaps"] >= 1, "remap did not fire"
    monkeypatch.setenv("SHEEP_VREMAP", "0")
    p_off, _ = P.forest_fixpoint_hosted(_t(lo), _t(hi), n)
    p_on, _ = R.forest_fixpoint_hosted(jnp.asarray(lo), jnp.asarray(hi), n)
    _eq(p_off, p_on)


@pytest.mark.parametrize("plateau", ["", "1"])
def test_reduce_rmat17_remap(monkeypatch, plateau):
    """R-MAT at scale 17: n > 2^16, so the vertex remap engages."""
    monkeypatch.setenv("SHEEP_PLATEAU_FORCE", plateau)
    calls = _count_remaps(monkeypatch)
    tail, head = rmat_edges(17, 1 << 14, seed=17)
    n = int(max(tail.max(), head.max())) + 1
    assert n > (1 << 16)
    lo, hi = _links(tail, head, n)
    _reduce_both(lo, hi, n)
    assert calls["remaps"] >= 1, "remap did not fire at scale 17"


@pytest.mark.parametrize("seed", range(10))
def test_forest_fixpoint_hosted_matches_oracle(seed):
    from sheep_tpu.core.forest import edges_to_positions

    rng = np.random.default_rng(900 + seed)
    tail, head = random_multigraph(rng, 80, 400)
    seq = degree_sequence(tail, head)
    want = build_forest(tail, head, seq, impl="python")
    lo, hi = edges_to_positions(tail, head, seq)
    n = len(seq)
    pst_only = hi >= n
    lo = np.where(pst_only, n, lo)
    hi = np.where(pst_only, n, hi)
    parent, rounds = P.forest_fixpoint_hosted(_t(lo), _t(hi), n)
    rparent, rrounds = R.forest_fixpoint_hosted(jnp.asarray(lo, jnp.int32),
                                                jnp.asarray(hi, jnp.int32), n)
    _eq(parent, rparent)
    assert rounds == rrounds
    forest = P._to_forest(parent, P.pst_weights(_t(lo), n), n)
    np.testing.assert_array_equal(forest.parent, want.parent)


@pytest.mark.parametrize("trial", range(4))
def test_forced_plateau_fixpoint_matches_oracle(monkeypatch, trial):
    monkeypatch.setenv("SHEEP_PLATEAU_FORCE", "1")
    rng = np.random.default_rng(4200 + trial)
    tail, head = random_multigraph(rng, n_max=300, e_max=2000)
    n = int(max(tail.max(), head.max())) + 1
    lo, hi = _links(tail, head, n)
    parent, _ = P.forest_fixpoint_hosted(_t(lo), _t(hi), n)
    rparent, _ = R.forest_fixpoint_hosted(jnp.asarray(lo), jnp.asarray(hi), n)
    _eq(parent, rparent)


def test_empty_links():
    e = torch.empty(0, dtype=torch.int32)
    lo, hi, live, rounds, conv = P.reduce_links_hosted(e, e, 5)
    assert (lo.numel(), live, rounds, conv) == (0, 0, 0, True)
    with pytest.raises(TypeError):
        P.reduce_links_hosted(np.zeros(3, np.int32), np.zeros(3, np.int32), 5)
