"""The native unpack of the 6-byte link handoff
(``native.unpack_links_6b`` over ``csrc/sheep_native.cpp``
``sheep_unpack_links_6b``) against the plain numpy decode
(``ops.forest.unpack_links_6b``) of the slices' concatenation masked to
lo < n, value for value and in order: random bytes, the 24-bit maximum,
dead sentinels scattered and as a tail, an empty buffer, a single link,
and windows of several slices; the returned count.  ``ops.build``'s
``unpack_handoff`` gives the same links and counts the dead slots."""

import numpy as np
import pytest
import torch

import sheep_tpu_torch.ops.build as PB
from sheep_tpu_torch import native
from sheep_tpu_torch.ops.forest import pack_links_6b, unpack_links_6b

N = 1 << 23
TOP = (1 << 24) - 1


def _pack(lo, hi) -> np.ndarray:
    return pack_links_6b(torch.from_numpy(np.asarray(lo, np.int32)),
                         torch.from_numpy(np.asarray(hi, np.int32))).numpy()


def _live(rng, k, n=N):
    lo = rng.integers(0, n, k)
    return lo, rng.integers(0, TOP + 1, k)


def _random_bytes(rng):
    return [rng.integers(0, 256, (5000, 6), dtype=np.uint8)], N


def _all_ff_kept(rng):
    # every byte 0xFF: lo = hi = 2^24 - 1, live where n = 2^24
    return [np.full((300, 6), 0xFF, np.uint8)], 1 << 24


def _all_ff_dead(rng):
    return [np.full((300, 6), 0xFF, np.uint8)], TOP


def _top_values(rng):
    lo, hi = _live(rng, 4000, 1 << 24)
    lo[::3] = TOP
    hi[::2] = TOP
    lo[1::7] = 0
    return [_pack(lo, hi)], 1 << 24


def _sentinels_scattered(rng):
    lo, hi = _live(rng, 6000)
    lo[rng.choice(6000, 700, replace=False)] = N
    return [_pack(lo, hi)], N


def _sentinel_tail(rng):
    lo, hi = _live(rng, 6000)
    lo[-1500:] = N
    hi[-1500:] = N
    return [_pack(lo, hi)], N


def _all_dead(rng):
    return [_pack(np.full(512, N), np.full(512, N))], N


def _empty(rng):
    return [np.empty((0, 6), np.uint8)], N


def _single_link(rng):
    return [_pack([12345], [TOP])], N


def _single_dead(rng):
    return [_pack([N], [N])], N


def _window_of_slices(rng):
    """Slices as a window hands them over: full ones, one of a single
    link, an empty one, a last one ending in dead slots."""
    sizes = (2048, 1, 2048, 0, 777)
    lo, hi = _live(rng, sum(sizes))
    lo[-100:] = N
    lo[5:4000:97] = N
    buf = _pack(lo, hi)
    cuts = np.cumsum((0,) + sizes)
    return [buf[a:b] for a, b in zip(cuts[:-1], cuts[1:])], N


CASES = {f.__name__.lstrip("_"): f for f in (
    _random_bytes, _all_ff_kept, _all_ff_dead, _top_values,
    _sentinels_scattered, _sentinel_tail, _all_dead, _empty, _single_link,
    _single_dead, _window_of_slices)}


def _want(slices, n):
    lo, hi = unpack_links_6b(np.concatenate(slices))
    keep = lo < n
    return lo[keep], hi[keep]


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_unpack_equals_numpy(case):
    slices, n = CASES[case](np.random.default_rng(len(case)))
    want_lo, want_hi = _want(slices, n)
    lo, hi = native.unpack_links_6b(slices, n)
    assert lo.dtype == hi.dtype == np.int32
    assert len(lo) == len(hi) == len(want_lo)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unpack_handoff(case):
    """``unpack_handoff``: the same links, and the dead slots it dropped."""
    slices, n = CASES[case](np.random.default_rng(len(case)))
    want_lo, want_hi = _want(slices, n)
    lo, hi, dead = PB.unpack_handoff(slices, n)
    assert dead == sum(len(s) for s in slices) - len(want_lo)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)


def test_native_unpack_no_slices():
    lo, hi = native.unpack_links_6b([], N)
    assert len(lo) == len(hi) == 0


@pytest.mark.parametrize("bad", [
    np.zeros((4, 8), np.uint8),               # not six bytes a link
    np.zeros((4, 6), np.int32),               # not bytes
    np.zeros((6, 6), np.uint8)[:, ::-1],      # not contiguous
    np.zeros(24, np.uint8),                   # flat
])
def test_native_unpack_refuses_malformed_slices(bad):
    with pytest.raises(TypeError):
        native.unpack_links_6b([np.zeros((2, 6), np.uint8), bad], N)
