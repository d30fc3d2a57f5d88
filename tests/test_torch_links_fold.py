"""The port's resumable fold (sheep_tpu_torch.native.LinksFold,
csrc/host_fold.cpp begin/block/finish) equals sheep_tpu's native
LinksFold, its PyLinksFold twin and the python oracle bit for bit, and the
monolithic fold, now one block of the same code, still equals the
reference."""

import numpy as np
import pytest

from sheep_tpu import INVALID_JNID
from sheep_tpu import native as ref_native
from sheep_tpu.core.forest import PyLinksFold
from sheep_tpu.core.forest import build_forest_links as ref_build_links
from sheep_tpu.core.forest import host_hi_window_bounds as ref_bounds

from sheep_tpu_torch import native
from sheep_tpu_torch.core import forest as PF


def _rand_links(rng, n, m, pst_only_frac=0.05):
    a = rng.integers(0, n, m)
    b = rng.integers(0, n, m)
    keep = a != b
    lo = np.minimum(a, b)[keep].astype(np.int64)
    hi = np.maximum(a, b)[keep].astype(np.int64)
    po = rng.random(len(lo)) < pst_only_frac
    hi[po] = INVALID_JNID  # pst-only links (absent endpoint)
    return lo, hi


def _eq(got, want_parent, want_pst):
    parent, pst = got
    assert parent.dtype == np.uint32 and pst.dtype == np.uint32
    np.testing.assert_array_equal(parent, want_parent)
    np.testing.assert_array_equal(pst, want_pst)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_links_fold_block_parity(seed, blocks):
    """Any ascending-hi block split (cuts inside an equal-hi group
    included), pst accumulated and given: the port's fold equals the
    reference's native and python folds and the python oracle."""
    rng = np.random.default_rng(800 + seed)
    n = int(rng.integers(50, 400))
    lo, hi = _rand_links(rng, n, int(rng.integers(10, 6 * n)))
    want = ref_build_links(lo, hi, n, impl="python")
    order = np.argsort(hi, kind="stable")
    lo_s, hi_s = lo[order], hi[order]
    cuts = [(len(lo_s) * k) // blocks for k in range(blocks + 1)]
    for pst in (None, want.pst_weight):
        folds = [PF.links_fold(n, pst), ref_native.LinksFold(n, pst),
                 PyLinksFold(n, pst)]
        for a, b in zip(cuts[:-1], cuts[1:]):
            for fold in folds:
                fold.block(lo_s[a:b], hi_s[a:b])
        for fold in folds:
            _eq(fold.finish(), want.parent, want.pst_weight)


def test_links_fold_out_of_order_window_raises():
    n = 10
    for fold in (native.LinksFold(n), ref_native.LinksFold(n)):
        fold.block(np.array([3], np.int64), np.array([7], np.int64))
        with pytest.raises(ValueError, match="ascend"):
            fold.block(np.array([1], np.int64), np.array([2], np.int64))


def test_links_fold_malformed_lo_raises():
    n = 10
    for fold in (native.LinksFold(n), ref_native.LinksFold(n)):
        with pytest.raises(ValueError):
            fold.block(np.array([12], np.int64), np.array([13], np.int64))


def test_links_fold_equal_hi_group_split_exact():
    lo = np.array([0, 1, 2, 3], np.int64)
    hi = np.array([5, 5, 5, 5], np.int64)
    n = 6
    want = ref_build_links(lo, hi, n, impl="python")
    fold = native.LinksFold(n)
    fold.block(lo[:2], hi[:2])
    fold.block(lo[2:], hi[2:])  # the same hi = 5 group continues
    _eq(fold.finish(), want.parent, want.pst_weight)


def test_links_fold_finished_and_bad_pst_raise():
    fold = native.LinksFold(4)
    fold.finish()
    with pytest.raises(RuntimeError):
        fold.block(np.array([0], np.int64), np.array([1], np.int64))
    with pytest.raises(ValueError):
        native.LinksFold(4, np.zeros(3, np.uint32))


@pytest.mark.parametrize("seed", range(4))
def test_monolithic_fold_still_equals_reference(seed):
    """sheep_build_forest, now begin + one block + finish, against the
    reference's native fold and the python oracle, pst counted and given;
    a malformed link still raises."""
    rng = np.random.default_rng(850 + seed)
    n = int(rng.integers(20, 600))
    lo, hi = _rand_links(rng, n, int(rng.integers(0, 8 * n)))
    want = ref_build_links(lo, hi, n, impl="python")
    for pst in (None, want.pst_weight):
        got = native.build_forest_links(lo, hi, n, pst)
        _eq(got, want.parent, want.pst_weight)
        _eq(got, *ref_native.build_forest_links(
            lo.astype(np.uint32), hi.astype(np.uint32), n, pst))
    with pytest.raises(RuntimeError):
        native.build_forest_links(np.array([n], np.int64),
                                  np.array([n + 1], np.int64), n)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 8])
def test_host_hi_window_bounds(w):
    rng = np.random.default_rng(870 + w)
    n = 1000
    for cnt in (0, 5, 997):
        hi = rng.integers(0, n, cnt)
        assert PF.host_hi_window_bounds(hi, w, n) == ref_bounds(hi, w, n)
