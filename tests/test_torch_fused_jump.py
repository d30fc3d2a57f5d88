"""Kernel K1 of the port (sheep_tpu_torch/ops/fused_jump.py) against the
JAX package's Pallas kernel and jnp descent.

On the CPU the port's descent is K1's plain torch version; the six cases
of tests/test_pallas_jump.py (seeds 600-605, 20% sentinels, levels 1-10)
must give exactly the lo and moved count of sheep_tpu's
``fused_jump(..., interpret=True)`` and ``ops.forest._jump``.  The CUDA
kernel itself runs only on the card: tests/test_torch_cuda.py holds it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.ops import pallas_jump as ref_pj
from sheep_tpu.ops.forest import _jump as ref_jump
from sheep_tpu.ops.forest import min_up_table as ref_min_up_table

from sheep_tpu_torch.ops import fused_jump as pj
from sheep_tpu_torch.ops.forest import min_up_table


def _case(trial):
    """The exact draws of test_pallas_jump.py::test_fused_jump_equals_jnp."""
    rng = np.random.default_rng(600 + trial)
    n = int(rng.integers(50, 4000))
    e = int(rng.integers(10, 20000))
    lo_np = rng.integers(0, n, e)
    hi_np = np.minimum(lo_np + rng.integers(1, n, e), n)
    dead = rng.random(e) < 0.2
    lo_np[dead] = n
    hi_np[dead] = n
    levels = int(rng.integers(1, 11))
    return n, lo_np.astype(np.int32), hi_np.astype(np.int32), levels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("trial", range(6))
def test_fused_descend_equals_pallas_and_jnp(trial):
    n, lo_np, hi_np, levels = _case(trial)
    lo, hi = jnp.asarray(lo_np), jnp.asarray(hi_np)
    want_lo, want_moved = ref_jump(lo, hi, n, levels)
    pal_lo, pal_moved = ref_pj.fused_jump(lo, hi, n, levels, interpret=True)
    f = min_up_table(_t(lo_np), _t(hi_np), n)
    got_lo, got_moved = pj.fused_descend(_t(lo_np), _t(hi_np), n, levels, f)
    assert got_lo.dtype == torch.int32 and got_moved.dtype == torch.int32
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(pal_lo))
    assert int(got_moved) == int(want_moved) == int(pal_moved)


@pytest.mark.parametrize("trial", range(6))
def test_plain_and_self_contained_forms_agree(trial):
    n, lo_np, hi_np, levels = _case(trial)
    f = min_up_table(_t(lo_np), _t(hi_np), n)
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(ref_min_up_table(lo_np, hi_np, n)))
    a_lo, a_moved = pj.fused_descend_plain(_t(lo_np), _t(hi_np), n,
                                           levels, f)
    b_lo, b_moved = pj.fused_jump(_t(lo_np), _t(hi_np), n, levels)
    want_lo, want_moved = ref_pj.fused_jump(
        jnp.asarray(lo_np), jnp.asarray(hi_np), n, levels, interpret=True)
    for got_lo, got_moved in ((a_lo, a_moved), (b_lo, b_moved)):
        np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))
        assert int(got_moved) == int(want_moved)


@pytest.mark.parametrize("levels", [1, 2, 5, 11])
def test_lift_tables_deepest_first(levels):
    rng = np.random.default_rng(610 + levels)
    n = 3000
    lo = rng.integers(0, n, 8000).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, 50, 8000), n).astype(np.int32)
    f = min_up_table(_t(lo), _t(hi), n)
    tables = pj.lift_tables(f, levels)
    assert tables.shape == (levels, n + 1) and tables.is_contiguous()
    # the reference squares f in jnp: tables[k] = f^(2^(levels-1-k))
    want = [jnp.asarray(f.numpy())]
    for _ in range(levels - 1):
        want.append(want[-1][want[-1]])
    for k, w in enumerate(reversed(want)):
        np.testing.assert_array_equal(tables[k].numpy(), np.asarray(w))


def test_jump_group_uses_plain_version_on_cpu():
    n, lo_np, hi_np, levels = _case(0)
    f = min_up_table(_t(lo_np), _t(hi_np), n)
    tables = pj.lift_tables(f, levels)
    before = pj.launches
    out = pj.jump_group(tables, _t(lo_np), _t(hi_np))
    assert pj.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(
        out.numpy(), pj.jump_group_plain(tables, _t(lo_np), _t(hi_np)).numpy())


def test_cuda_wrapper_rejects_cpu_tensors():
    tables = torch.zeros((2, 9), dtype=torch.int32)
    lo = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pj.jump_group_cuda(tables, lo, lo.clone())


@pytest.mark.parametrize("bad", ["lo_dtype", "hi_dtype", "tables_dtype",
                                 "lo_strided", "tables_strided", "shape",
                                 "tables_1d"])
def test_wrappers_reject_bad_input(bad):
    tables = torch.zeros((2, 9), dtype=torch.int32)
    lo = torch.zeros(6, dtype=torch.int32)
    hi = torch.ones(6, dtype=torch.int32)
    if bad == "lo_dtype":
        lo = lo.long()
    elif bad == "hi_dtype":
        hi = hi.to(torch.int16)
    elif bad == "tables_dtype":
        tables = tables.long()
    elif bad == "lo_strided":
        lo = torch.zeros(12, dtype=torch.int32)[::2]
    elif bad == "tables_strided":
        tables = torch.zeros((9, 2), dtype=torch.int32).t()
    elif bad == "shape":
        hi = torch.ones(5, dtype=torch.int32)
    elif bad == "tables_1d":
        tables = torch.zeros(9, dtype=torch.int32)
    for fn in (pj.jump_group_cuda, pj.jump_group):
        with pytest.raises((TypeError, ValueError)):
            fn(tables, lo, hi)


# --- L2-sized table groups (plan_groups, descend_groups) -------------------

#: the reference's test sizes (tests/test_pallas_jump.py draws n in
#: [50, 4000)), then sizes up to the real build's n = 2^23
_PLAN_NS = [50, 1000, 3999, 1 << 16, 1 << 20, 1 << 21, 1 << 22, 1 << 23]
#: from a budget below one table to past the H100's 50 MB
_PLAN_L2 = [1, 4096, 6 << 20, 40 << 20, 50 << 20, 96 << 20]


@pytest.mark.parametrize("l2_bytes", _PLAN_L2)
@pytest.mark.parametrize("n", _PLAN_NS)
def test_plan_groups_cover_every_level_once_within_budget(n, l2_bytes):
    width = n + 1
    budget = int(l2_bytes * pj.L2_TABLE_SHARE)
    g = max(1, budget // (4 * width))
    for levels in range(1, 25):
        groups = pj.plan_groups(levels, width, l2_bytes)
        # every level once, in order: deepest first, as tables are stored
        assert [k for a, b in groups for k in range(a, b)] == \
            list(range(levels))
        assert all(b - a == g for a, b in groups[:-1])
        assert 1 <= groups[-1][1] - groups[-1][0] <= g
        for a, b in groups:
            assert b - a == 1 or 4 * width * (b - a) <= budget


def test_plan_groups_at_the_h100_l2():
    l2 = 50 << 20  # what cudaDevAttrL2CacheSize reports on an H100
    # one table a launch at the real build's n = 2^23 (33.5 MB) and at
    # n = 2^22 (16.8 MB)
    for log_n in (22, 23):
        assert pj.plan_groups(4, (1 << log_n) + 1, l2) == [
            (0, 1), (1, 2), (2, 3), (3, 4)]
    assert pj.plan_groups(12, (1 << 21) + 1, l2) == [(0, 3), (3, 6), (6, 9),
                                                     (9, 12)]
    # six 4 MB tables a pass at n = 2^20
    assert pj.plan_groups(10, (1 << 20) + 1, l2) == [(0, 6), (6, 10)]


@pytest.mark.parametrize("n", _PLAN_NS)
def test_plan_groups_sorted_links_take_one_pass(n):
    for levels in (1, 4, 16, 24):
        for l2 in _PLAN_L2:
            assert pj.plan_groups(levels, n + 1, l2, sorted_links=True) == \
                [(0, levels)]


@pytest.mark.parametrize("bad", [(0, 10, 100), (3, 0, 100), (3, 10, 0)])
def test_plan_groups_rejects_empty_arguments(bad):
    with pytest.raises(ValueError):
        pj.plan_groups(*bad)


def _links_of(kind):
    """Seeded links with 20% sentinels: random lo, lo sorted by (lo, hi)
    as after sort_links, or lo drawn past the table (clamped gathers)."""
    rng = np.random.default_rng({"random": 620, "sorted": 621,
                                 "past": 622}[kind])
    n, e, levels = 3000, 9001, 7
    over = 40 if kind == "past" else 0
    lo = rng.integers(0, n + over, e)
    hi = np.minimum(lo + rng.integers(1, n, e), n + over)
    dead = rng.random(e) < 0.2
    lo[dead] = n
    hi[dead] = n
    if kind == "sorted":
        order = np.lexsort((hi, lo))
        lo, hi = lo[order], hi[order]
    # the one-step table of the in-range links (slot n absorbs the rest)
    f = np.full(n + 1, n, np.int64)
    keep = lo <= n
    np.minimum.at(f, lo[keep], np.minimum(hi[keep], n))
    return n, lo.astype(np.int32), hi.astype(np.int32), \
        f.astype(np.int32), levels


@pytest.mark.parametrize("g", [1, 2, 3, 7])
@pytest.mark.parametrize("kind", ["random", "sorted", "past"])
def test_descent_group_by_group_equals_pallas_reference(kind, g):
    """The plain descent applied one planned group at a time equals the
    reference's fused_descend and, group by group, its jump_group (both
    in interpret mode), exactly."""
    n, lo_np, hi_np, f_np, levels = _links_of(kind)
    width = n + 1
    l2 = int(g * 4 * width / pj.L2_TABLE_SHARE) + 64
    groups = pj.plan_groups(levels, width, l2)
    assert len(groups) == -(-levels // g)
    tables = pj.lift_tables(_t(f_np), levels)
    got = pj.descend_groups(tables, _t(lo_np), _t(hi_np), groups)
    want, want_moved = ref_pj.fused_descend(
        jnp.asarray(lo_np), jnp.asarray(hi_np), n, levels,
        jnp.asarray(f_np), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got != _t(lo_np)).sum()) == int(want_moved)
    # each group on its own, against the reference kernel on that group
    cur = jnp.asarray(lo_np)
    mine = _t(lo_np)
    for start, stop in groups:
        group = tuple(jnp.asarray(tables[k].numpy())
                      for k in range(start, stop))
        cur = ref_pj.jump_group(group, cur, jnp.asarray(hi_np),
                                interpret=True)
        mine = pj.descend_groups(tables, mine, _t(hi_np), [(start, stop)])
        np.testing.assert_array_equal(mine.numpy(), np.asarray(cur))


def test_fused_descend_counts_moved_against_its_input():
    n, lo_np, hi_np, f_np, levels = _links_of("sorted")
    lo_in = _t(lo_np)
    out, moved = pj.fused_descend(lo_in, _t(hi_np), n, levels, _t(f_np))
    np.testing.assert_array_equal(lo_in.numpy(), lo_np)  # not written
    assert int(moved) == int((out != lo_in).sum()) > 0


def test_l2_cache_bytes_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        pj.l2_cache_bytes(torch.device("cpu"))


def test_only_sorted_rounds_ask_for_one_pass(monkeypatch):
    """The reduce loop's jump-only opener descends unsorted links (L2-sized
    groups on the card); every chunk round sorts first and says so."""
    from sheep_tpu_torch.ops import forest as pf
    from sheep_tpu_torch.utils import rmat_edges

    seen = []
    descend = pf._lift_descend

    def recorded(lo, hi, n, levels, f, sorted_links=False):
        seen.append(sorted_links)
        return descend(lo, hi, n, levels, f, sorted_links)

    monkeypatch.setattr(pf, "_lift_descend", recorded)
    tail, head = rmat_edges(12, 8 << 12, seed=4)
    n = 1 << 12
    lo = torch.from_numpy(np.minimum(tail, head).astype(np.int32))
    hi = torch.from_numpy(np.maximum(tail, head).astype(np.int32))
    keep = lo != hi
    pf.reduce_links_hosted(lo[keep], hi[keep], n)
    assert len(seen) >= 2 and seen[0] is False and all(seen[1:])


def _wild(n, seed, off=0, extra=0, levels=3):
    """K1's tables over a seeded f, and lo drawn below 0 (down to -n - 37,
    so past the wrap too) and at or past the width, as views at storage
    offset ``off`` of longer buffers."""
    rng = np.random.default_rng(seed)
    f = np.minimum(np.arange(n + 1) + rng.integers(1, 64, n + 1), n)
    size = n + extra
    lo = rng.integers(-n - 37, n + 37, size + off)
    hi = lo + rng.integers(-3, 1024, size + off)
    lo_t = _t(lo)[off:off + size]
    hi_t = _t(hi)[off:off + size]
    return pj.lift_tables(_t(f), levels), lo_t, hi_t


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("log_n", [8, 11])
def test_jump_group_plain_offset_views_and_wild_lo(log_n, off, levels):
    """K1's plain version on views at storage offsets 0-3 (the layouts
    that take the kernel's scalar path; extra = 3 gives an E % 4 tail)
    with lo below 0 and past the table: equal to the reference's
    jump_group in interpret mode, which counts a negative index from the
    end and clamps the rest, arrays whole."""
    n = 1 << log_n
    tables, lo, hi = _wild(n, seed=log_n + off + 10 * levels, off=off,
                           extra=3, levels=levels)
    assert lo.storage_offset() == off
    assert (lo < -n).any() and (lo < 0).any() and (lo > n).any()
    got = pj.jump_group_plain(tables, lo, hi).numpy()
    want = ref_pj.jump_group(tuple(jnp.asarray(t.numpy()) for t in tables),
                             jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                             interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    # and through the dispatcher on the CPU: the plain version, no launch
    before = pj.launches
    np.testing.assert_array_equal(pj.jump_group(tables, lo, hi).numpy(), got)
    assert pj.launches == before


def test_jump_group_plain_counts_a_negative_lo_from_the_end():
    """The ROADMAP's input: f = arange(100, 200), lo = [-3], hi = [1000]
    gives [197] in the reference, and so in the port."""
    f = torch.arange(100, 200, dtype=torch.int32)
    lo = torch.tensor([-3], dtype=torch.int32)
    hi = torch.tensor([1000], dtype=torch.int32)
    got = pj.jump_group_plain(f[None, :], lo, hi)
    want = ref_pj.jump_group((jnp.asarray(f.numpy()),),
                             jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                             interpret=True)
    assert got.tolist() == [197] == np.asarray(want).tolist()
