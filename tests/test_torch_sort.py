"""Prep ops of the port (sheep_tpu_torch/ops/sort.py) equal sheep_tpu's
(ops/sort.py, JAX on the CPU) exactly on the same seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_multigraph

from sheep_tpu.ops import sort as R
from sheep_tpu_torch.ops import sort as P
from sheep_tpu_torch.convert import edges_to_device


def _graph(seed, n_max=200, e_max=1200):
    rng = np.random.default_rng(seed)
    tail, head = random_multigraph(rng, n_max, e_max)
    return tail, head, int(max(tail.max(), head.max())) + 1


def _eq(got: torch.Tensor, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_degree_histogram(seed):
    tail, head, n = _graph(5000 + seed)
    t, h = edges_to_device(tail, head, "cpu")
    _eq(P.degree_histogram(t, h, n),
        R.degree_histogram(jnp.asarray(tail), jnp.asarray(head), n))


@pytest.mark.parametrize("seed", range(4))
def test_degree_order_with_zero_degree_vids(seed):
    rng = np.random.default_rng(5100 + seed)
    deg = rng.integers(0, 50, 4096).astype(np.int32)
    deg[rng.random(4096) < 0.3] = 0
    seq, pos, m = P.degree_order(torch.from_numpy(deg))
    rseq, rpos, rm = R.degree_order(jnp.asarray(deg))
    _eq(seq, rseq)
    _eq(pos, rpos)
    assert m.dtype == torch.int32 and int(m) == int(rm)


@pytest.mark.parametrize("seed", range(4))
def test_edge_links(seed):
    tail, head, n = _graph(5200 + seed)
    t, h = edges_to_device(tail, head, "cpu")
    _, pos, _ = P.degree_order(P.degree_histogram(t, h, n))
    _, rpos, _ = R.degree_order(R.degree_histogram(
        jnp.asarray(tail), jnp.asarray(head), n))
    lo, hi = P.edge_links(t, h, pos, n)
    rlo, rhi = R.edge_links(jnp.asarray(tail), jnp.asarray(head), rpos, n)
    _eq(lo, rlo)
    _eq(hi, rhi)


@pytest.mark.parametrize("with_pst", [True, False])
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_given_seq_links(seed, subset, with_pst):
    # a SUBSET sequence leaves vids absent: their edges count toward pst
    # at the present endpoint and never enter the tree
    from sheep_tpu.core import degree_sequence

    tail, head, n = _graph(5300 + seed)
    seq = degree_sequence(tail, head)
    if subset:
        rng = np.random.default_rng(seed)
        seq = seq[rng.permutation(len(seq))[: max(2, len(seq) * 2 // 3)]]
    t, h = edges_to_device(tail, head, "cpu")
    lo, hi, pst = P.given_seq_links(t, h, seq, n, with_pst=with_pst)
    rlo, rhi, rpst = R.given_seq_links(tail, head, seq, n, with_pst=with_pst)
    _eq(lo, rlo)
    _eq(hi, rhi)
    if with_pst:
        _eq(pst, rpst)
    else:
        assert pst is None and rpst is None


@pytest.mark.parametrize("trial", range(15))
def test_degree_sequence_device(trial):
    rng = np.random.default_rng(3000 + trial)
    tail, head = random_multigraph(rng)
    got = P.degree_sequence_device(tail, head, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, R.degree_sequence_device(tail, head))


def test_degree_sequence_device_rmat():
    from sheep_tpu_torch.utils import rmat_edges

    tail, head = rmat_edges(12, 4 << 12, seed=3)
    np.testing.assert_array_equal(
        P.degree_sequence_device(tail, head, device="cpu"),
        R.degree_sequence_device(tail, head))
    assert len(P.degree_sequence_device(np.empty(0, np.uint32),
                                        np.empty(0, np.uint32),
                                        device="cpu")) == 0
