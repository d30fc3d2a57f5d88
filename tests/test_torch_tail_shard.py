"""The port's sharded gather-tail (sheep_tpu_torch.parallel.chunked)
against the reference's, mirroring tests/test_tail_shard.py.

The gathered union is re-split by hi-quantile window, each window's chain
segments collapse with local rounds on their worker, and the per-window
forests gather again for the replicated finish.  On the same seeded
R-MAT inputs, with the reference on its 8-device virtual CPU mesh and
the port on W CPU workers, the parents, the round counts and the comm
model (tail-shard rounds, each row's live count at the handoff, the live
counts into the shard and into the finish) are equal, exactly, shard on
and off, for W in {1, 2, 3, 8}.
"""

import numpy as np
import pytest
import torch

import sheep_tpu.parallel as ref_par
import sheep_tpu_torch.parallel as par
from sheep_tpu.core import build_forest, degree_sequence
from sheep_tpu.parallel import chunked as ref_chunked
from sheep_tpu.utils import rmat_edges
from sheep_tpu_torch.parallel import chunked
from sheep_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device("cpu")


@pytest.fixture
def workers(monkeypatch):
    def use(w):
        monkeypatch.setattr(port_mesh, "mesh_devices",
                            lambda device: [CPU] * w)
    return use


def both(tail, head, n, w, **kw):
    """build_links_chunked_sharded on both packages; asserts equal
    outputs, rounds and comm, and returns (parent, comm)."""
    rmesh = ref_par.make_mesh(w)
    rt2, rh2 = ref_chunked.stage_edges_2d(tail, head, n, rmesh)
    rcomm, rtm = {}, {}
    ref = ref_chunked.build_links_chunked_sharded(
        rt2, rh2, n, rmesh, comm=rcomm, timings=rtm, **kw)
    pmesh = par.make_mesh(w, "cpu")
    pt2, ph2 = chunked.stage_edges_2d(tail, head, n, pmesh)
    comm, tm = {}, {}
    got = chunked.build_links_chunked_sharded(
        pt2, ph2, n, pmesh, comm=comm, timings=tm, **kw)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tm["reduce_rounds"] == rtm["reduce_rounds"]
    assert comm == rcomm
    return got[3].numpy(), comm


def oracle_parent(tail, head, n):
    want = build_forest(tail, head, degree_sequence(tail, head))
    return want, np.where(want.parent == 0xFFFFFFFF, n,
                          want.parent.astype(np.int64))


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_tail_shard_parity(workers, w):
    """Shard on == shard off == the reference == the oracle."""
    workers(w)
    log_n = 12
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=61)
    want, wantp = oracle_parent(tail, head, n)
    m = want.n
    p_on, comm_on = both(tail, head, n, w, gather_tail=True,
                         tail_shard=True)
    p_off, _ = both(tail, head, n, w, gather_tail=True, tail_shard=False)
    np.testing.assert_array_equal(p_on, p_off)
    np.testing.assert_array_equal(p_on[:m].astype(np.int64), wantp)
    if w > 1:
        assert comm_on["tail_shard_rounds"] > 0
        assert len(comm_on["tail_shard_row_live"]) == w


def test_quantile_windows_equal_reference(workers):
    """Each worker's live count at the shard handoff (the equal-count
    hi-quantile windows) equals the reference's, and is balanced."""
    workers(8)
    log_n = 12
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=62)
    _, comm = both(tail, head, n, 8, tail_shard=True)
    rl = comm["tail_shard_row_live"]
    assert max(rl) <= 2 * (sum(rl) / len(rl)), rl


def test_round0_bypass_guard(workers):
    """A sparse input whose whole window fits the gather budget at round
    zero still runs one sharded chunk before gathering."""
    workers(8)
    rng = np.random.default_rng(64)
    n = 1 << 11
    verts = rng.permutation(n // 2).astype(np.uint32)
    tail, head = verts[:-1], verts[1:]
    parent, comm = both(tail, head, n, 8, tail_shard=True)
    assert comm["gather_payload_bytes"] > 0
    assert comm["sharded_global_rounds"] >= 1
    want, wantp = oracle_parent(tail, head, n)
    np.testing.assert_array_equal(parent[:want.n].astype(np.int64), wantp)


def test_local_round_cap_honored(workers, monkeypatch):
    """SHEEP_MESH_TAIL_SHARD_ROUNDS bounds the local pass, on both."""
    monkeypatch.setenv("SHEEP_MESH_TAIL_SHARD_ROUNDS", "3")
    workers(3)
    log_n = 12
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=65)
    parent, comm = both(tail, head, n, 3, tail_shard=True)
    assert 0 < comm["tail_shard_rounds"] <= 3
    want, wantp = oracle_parent(tail, head, n)
    np.testing.assert_array_equal(parent[:want.n].astype(np.int64), wantp)


def test_streaming_fold_with_shard(workers):
    """The chunked streaming fold with the sharded tail at every block."""
    from sheep_tpu.core.sequence import sequence_positions

    workers(8)
    log_n = 11
    n = 1 << log_n
    tail, head = rmat_edges(log_n, 4 * n, seed=66)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    m = len(want_seq)
    pos = sequence_positions(want_seq, n - 1)
    block = len(tail) // 3 + 1

    def blocks():
        return ((tail[a:a + block], head[a:a + block])
                for a in range(0, len(tail), block))

    ref, ref_rounds = ref_par.build_graph_streaming_chunked(
        blocks(), max(n, m), pos, block_edges=block, num_workers=8)
    got, rounds = par.build_graph_streaming_chunked(
        blocks(), max(n, m), pos, block_edges=block, num_workers=8,
        device="cpu")
    assert rounds == ref_rounds
    np.testing.assert_array_equal(got.parent, ref.parent)
    np.testing.assert_array_equal(got.pst_weight, ref.pst_weight)
    np.testing.assert_array_equal(got.parent[:m], want.parent)


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_window_split_equals_reference(w):
    """hi_window_bounds and shard_links_by_window, row for row."""
    import jax.numpy as jnp

    rng = np.random.default_rng(70 + w)
    n = 500
    lo = rng.integers(0, n, 400).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, 100, 400), n).astype(np.int32)
    dead = rng.random(400) < 0.25
    lo[dead] = n
    hi[dead] = n
    sh = np.sort(hi)
    cnt = int((lo < n).sum())
    np.testing.assert_array_equal(
        np.asarray(ref_chunked.hi_window_bounds(jnp.asarray(sh), cnt, w, n)),
        chunked.hi_window_bounds(torch.from_numpy(sh),
                                 torch.tensor(cnt, dtype=torch.int32), w,
                                 n).numpy())
    rmesh = ref_par.make_mesh(w)
    rlo, rhi = ref_chunked.shard_links_by_window(
        jnp.asarray(lo), jnp.asarray(hi), n, rmesh)
    pmesh = par.Mesh([CPU] * w)
    plo, phi = chunked.shard_links_by_window(
        torch.from_numpy(lo), torch.from_numpy(hi), n, pmesh)
    np.testing.assert_array_equal(np.asarray(rlo),
                                  np.stack([x.numpy() for x in plo]))
    np.testing.assert_array_equal(np.asarray(rhi),
                                  np.stack([x.numpy() for x in phi]))
    assert chunked.row_live_counts(plo, n, pmesh) == [
        int(x) for x in ref_chunked.row_live_counts(rlo, n, rmesh)]
