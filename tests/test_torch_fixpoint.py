"""The port's fixpoint (sheep_tpu_torch/ops/forest.py ``forest_fixpoint``)
against sheep_tpu's single-dispatch while_loop (JAX on the CPU) and the
whole-graph oracle: parent and round count equal, at several n, with
jump levels given and defaulted.  Split from tests/test_torch_stream.py,
whose streaming builds run the fixpoint per block."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sheep_tpu.ops.forest as RF
from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence, sequence_positions

import sheep_tpu_torch.ops.forest as PF
from sheep_tpu_torch.utils import rmat_edges


def _links(n, e, seed, dead=0.2):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n - 1, e)
    hi = np.minimum(lo + rng.integers(1, n, e), n - 1)
    keep = lo < hi
    lo, hi = lo[keep], hi[keep]
    mask = rng.random(len(lo)) < dead
    lo[mask] = n
    hi[mask] = n
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("jump_levels", [None, 1, 3, 40])
@pytest.mark.parametrize("n,e", [(2, 5), (50, 300), (700, 2500),
                                 (5000, 40_000)])
def test_forest_fixpoint_equals_reference(n, e, jump_levels):
    """Parent and round count equal the reference's single-dispatch
    while_loop, at several n, jump_levels given and defaulted."""
    lo, hi = _links(n, e, seed=n + e)
    got, rounds = PF.forest_fixpoint(torch.from_numpy(lo),
                                     torch.from_numpy(hi), n,
                                     jump_levels=jump_levels)
    want, want_rounds = RF.forest_fixpoint(jnp.asarray(lo), jnp.asarray(hi),
                                           n, jump_levels=jump_levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)


def test_forest_fixpoint_hub_star_sorts():
    """A hub star unrolls one chain link a jump round until the sort
    rewrite at rounds 7, 15, ...: the round count that schedule gives is
    the reference's."""
    n = 300
    lo = np.zeros(n - 1, np.int32)
    hi = np.arange(1, n, dtype=np.int32)
    got, rounds = PF.forest_fixpoint(torch.from_numpy(lo),
                                     torch.from_numpy(hi), n, jump_levels=1)
    want, want_rounds = RF.forest_fixpoint(jnp.asarray(lo), jnp.asarray(hi),
                                           n, jump_levels=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds) >= 8


def test_forest_fixpoint_empty_and_oracle():
    got, rounds = PF.forest_fixpoint(torch.empty(0, dtype=torch.int32),
                                     torch.empty(0, dtype=torch.int32), 4)
    assert rounds == 0 and got.tolist() == [4, 4, 4, 4]
    tail, head = rmat_edges(10, 8 << 10, seed=2)
    seq = degree_sequence(tail, head)
    pos = sequence_positions(seq, 1023)
    n = len(seq)
    pt = pos[tail].astype(np.int64)
    ph = pos[head].astype(np.int64)
    lo = np.minimum(pt, ph)
    hi = np.maximum(pt, ph)
    dead = (lo >= hi) | (hi >= n)
    lo[dead] = n
    hi[dead] = n
    parent, _ = PF.forest_fixpoint(torch.from_numpy(lo.astype(np.int32)),
                                   torch.from_numpy(hi.astype(np.int32)), n)
    want = build_forest(tail, head, seq)
    p = parent.numpy().astype(np.int64)
    np.testing.assert_array_equal(np.where(p < n, p, 0xFFFFFFFF),
                                  want.parent.astype(np.int64))
