"""The port's mesh build (sheep_tpu_torch.parallel) against the
reference's (sheep_tpu.parallel), mirroring tests/test_parallel.py.

The reference runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port's mesh takes its workers from ``parallel.mesh.mesh_devices``,
patched here to W copies of the CPU, as the reference's tests force
virtual devices.  The same seeded inputs go through both with W in {1,
2, 3, 8}; seq, parent, pst, each worker's partial and the round counts
must be equal, exactly, and equal the host oracle.  Also here: the
mesh's collectives, the single-dispatch twin (``distributed_build_step``,
SHEEP_MESH_KERNEL=loop), the fixpoint streaming twin, and the device
helpers of ops.forest and ops.build against the reference's.
"""

import os

import numpy as np
import pytest
import torch

import sheep_tpu.parallel as ref_par
import sheep_tpu_torch.parallel as par
from sheep_tpu.core import build_forest, degree_sequence
from sheep_tpu_torch.parallel import mesh as port_mesh

CPU = torch.device("cpu")
HEP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "hep-th.dat")
#: one shape for every drawn graph, so the reference's compiled programs
#: are reused from test to test
N, E = 64, 256


def graph(seed: int, n: int = N, e: int = E):
    """A random multigraph (self-loops and repeats kept) of e records over
    exactly n vertex ids."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    tail[0] = n - 1
    return tail, head


@pytest.fixture
def workers(monkeypatch):
    """``use(w)`` gives the port's mesh w CPU workers."""
    def use(w):
        monkeypatch.setattr(port_mesh, "mesh_devices",
                            lambda device: [CPU] * w)
    return use


def assert_forest(got, want):
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.pst_weight, want.pst_weight)


def oracle(tail, head, seq=None):
    seq = degree_sequence(tail, head) if seq is None else seq
    return seq, build_forest(tail, head, seq,
                             max_vid=int(max(tail.max(), head.max())))


@pytest.mark.parametrize("kernel", ["chunked", "loop"])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_distributed_equals_reference(workers, monkeypatch, w, kernel):
    workers(w)
    monkeypatch.setenv("SHEEP_MESH_KERNEL", kernel)
    tail, head = graph(100 + w)
    want_seq, want = oracle(tail, head)
    ref_seq, ref = ref_par.build_graph_distributed(tail, head,
                                                   num_workers=w)
    seq, forest = par.build_graph_distributed(tail, head, num_workers=w,
                                              device="cpu")
    np.testing.assert_array_equal(seq, ref_seq)
    np.testing.assert_array_equal(seq, want_seq)
    assert_forest(forest, ref)
    assert_forest(forest, want)


@pytest.mark.parametrize("w", [1, 3, 8])
def test_distributed_given_sequence(workers, w):
    """`-r` without `-i`: a given sequence that leaves out vertices (their
    edges count as pst of the present endpoint)."""
    workers(w)
    tail, head = graph(700 + w)
    full = degree_sequence(tail, head)
    seq = full[:max(1, len(full) - 3)]
    _, want = oracle(tail, head, seq)
    ref_seq, ref = ref_par.build_graph_distributed(tail, head, seq=seq,
                                                   num_workers=w)
    got_seq, forest = par.build_graph_distributed(tail, head, seq=seq,
                                                  num_workers=w,
                                                  device="cpu")
    np.testing.assert_array_equal(got_seq, ref_seq)
    assert_forest(forest, ref)
    assert_forest(forest, want)


@pytest.mark.parametrize("kernel", ["chunked", "loop"])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_map_only_partials_equal_reference(workers, monkeypatch, w, kernel):
    """Each worker's partial forest (its shard's records, its own pst)
    equals the reference's worker for worker, and the partials merge to
    the whole tree."""
    from sheep_tpu_torch.core.forest import merge_forests

    workers(w)
    monkeypatch.setenv("SHEEP_MESH_KERNEL", kernel)
    tail, head = graph(42 + w)
    ref_seq, ref_parts = ref_par.map_graph_distributed(tail, head,
                                                       num_workers=w)
    seq, parts = par.map_graph_distributed(tail, head, num_workers=w,
                                           device="cpu")
    np.testing.assert_array_equal(seq, ref_seq)
    assert len(parts) == len(ref_parts) == w
    for got, want in zip(parts, ref_parts):
        assert_forest(got, want)
    assert_forest(merge_forests(*parts), oracle(tail, head)[1])


@pytest.mark.parametrize("with_seq", [False, True])
def test_map_only_given_sequence(workers, with_seq):
    workers(3)
    tail, head = graph(4242)
    seq_arg = degree_sequence(tail, head)[:-2] if with_seq else None
    ref_seq, ref_parts = ref_par.map_graph_distributed(
        tail, head, num_workers=3, seq=seq_arg)
    seq, parts = par.map_graph_distributed(tail, head, num_workers=3,
                                           seq=seq_arg, device="cpu")
    np.testing.assert_array_equal(seq, ref_seq)
    for got, want in zip(parts, ref_parts):
        assert_forest(got, want)


@pytest.mark.parametrize("kernel", ["chunked", "loop"])
def test_edges_fewer_than_workers(workers, monkeypatch, kernel):
    workers(8)
    monkeypatch.setenv("SHEEP_MESH_KERNEL", kernel)
    tail = np.array([0], dtype=np.uint32)
    head = np.array([1], dtype=np.uint32)
    seq, forest = par.build_graph_distributed(tail, head, num_workers=8,
                                              device="cpu")
    assert list(seq) == [0, 1]
    assert list(forest.parent) == [1, 0xFFFFFFFF]
    assert list(forest.pst_weight) == [1, 0]
    _, parts = par.map_graph_distributed(tail, head, num_workers=8,
                                         device="cpu")
    _, ref_parts = ref_par.map_graph_distributed(tail, head, num_workers=8)
    for got, want in zip(parts, ref_parts):
        assert_forest(got, want)


@pytest.mark.parametrize("kernel", ["chunked", "loop"])
def test_empty_graph(workers, monkeypatch, kernel):
    workers(4)
    monkeypatch.setenv("SHEEP_MESH_KERNEL", kernel)
    empty = np.empty(0, np.uint32)
    seq, forest = par.build_graph_distributed(empty, empty, num_workers=4,
                                              device="cpu")
    assert len(seq) == 0 and forest.n == 0
    seq, parts = par.map_graph_distributed(empty, empty, num_workers=4,
                                           device="cpu")
    assert len(seq) == 0 and parts == []


def test_hepth_distributed(workers):
    from sheep_tpu_torch.io import load_edges

    workers(8)
    el = load_edges(HEP)
    tail, head = el.tail, el.head
    seq, forest = par.build_graph_distributed(tail, head, device="cpu")
    want_seq, want = oracle(tail, head)
    np.testing.assert_array_equal(seq, want_seq)
    assert_forest(forest, want)


@pytest.mark.parametrize("do_merge", [True, False])
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("w", [2, 3])
def test_distributed_build_step_equals_reference(workers, w, with_pos,
                                                 do_merge):
    """The single-dispatch twin: every output, the merge (or map) round
    count included, equals the reference's."""
    from sheep_tpu.core.sequence import sequence_positions
    from sheep_tpu_torch.parallel.build import _pad_edges

    workers(w)
    tail, head = graph(900 + w)
    n = int(max(tail.max(), head.max())) + 1
    seq = degree_sequence(tail, head)[:-2]
    pos = sequence_positions(seq, n - 1).astype(np.int64).astype(np.int32)
    rmesh = ref_par.make_mesh(w)
    t_np, h_np = _pad_edges(tail, head, n, w)
    from jax.sharding import PartitionSpec as P
    from sheep_tpu.parallel.build import _stage
    rt = _stage(t_np.reshape(-1), rmesh, P("workers"))
    rh = _stage(h_np.reshape(-1), rmesh, P("workers"))
    kw = dict(do_merge=do_merge)
    pmesh = par.make_mesh(w, "cpu")
    if with_pos:
        kw.update(with_pos=True)
        ref = ref_par.distributed_build_step(
            rt, rh, n, rmesh, pos=_stage(pos, rmesh, P()), **kw)
        got = par.distributed_build_step(
            pmesh.rows(t_np), pmesh.rows(h_np), n, pmesh,
            pos=pmesh.replicate(pos), **kw)
    else:
        ref = ref_par.distributed_build_step(rt, rh, n, rmesh, **kw)
        got = par.distributed_build_step(pmesh.rows(t_np),
                                         pmesh.rows(h_np), n, pmesh, **kw)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a),
                                      b.numpy() if isinstance(
                                          b, torch.Tensor) else b)


def test_collectives():
    mesh = par.Mesh([CPU] * 3)
    xs = [torch.tensor([i, 5 - 2 * i, 7], dtype=torch.int32)
          for i in range(3)]
    assert mesh.size == 3 and mesh.offset == 0 and mesh.home == CPU
    assert mesh.psum(xs).tolist() == [3, 9, 21]
    assert mesh.pmin(xs).tolist() == [0, 1, 7]
    assert mesh.pmax(xs).tolist() == [2, 5, 7]
    assert mesh.all_gather(xs).tolist() == [x.tolist() for x in xs]
    # the combine never writes into a worker's tensor
    assert xs[0].tolist() == [0, 5, 7]
    rows = mesh.rows(np.arange(6, dtype=np.int32).reshape(3, 2))
    assert [r.tolist() for r in rows] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError):
        mesh.rows(np.zeros((2, 2), np.int32))


def test_make_mesh_counts_devices(workers):
    assert port_mesh.mesh_devices("cpu") == [CPU]
    assert par.make_mesh(device="cpu").size == 1
    workers(8)
    assert par.make_mesh(device="cpu").size == 8
    assert par.make_mesh(3, "cpu").size == 3
    assert port_mesh.mesh_size("cpu") == 8
    with pytest.raises(ValueError, match="requested 9 workers"):
        par.make_mesh(9, "cpu")
    assert ref_par.AXIS == par.AXIS


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    tail = np.array([0, 1], np.uint32)
    head = np.array([1, 2], np.uint32)
    for fn in (par.build_graph_distributed, par.map_graph_distributed,
               par.build_graph_chunked_distributed,
               par.map_graph_chunked_distributed):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(tail, head)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        par.make_mesh()


def test_public_names_are_the_references():
    assert set(ref_par.__all__) <= set(par.__all__)


@pytest.mark.parametrize("w,block", [(8, 64), (3, 100), (1, 64)])
def test_streaming_sharded_equals_reference(workers, w, block):
    """The fixpoint streaming twin: forest and per-block merge rounds."""
    from sheep_tpu.core.sequence import sequence_positions

    workers(w)
    tail, head = graph(3100 + w)
    seq, want = oracle(tail, head)
    pos = sequence_positions(seq, int(max(tail.max(), head.max())))
    n = len(seq)

    def blocks():
        return ((tail[a:a + block], head[a:a + block])
                for a in range(0, len(tail), block))

    ref, ref_rounds = ref_par.build_graph_streaming_sharded(
        blocks(), n, pos, block_edges=block, num_workers=w)
    got, rounds = par.build_graph_streaming_sharded(
        blocks(), n, pos, block_edges=block, num_workers=w, device="cpu")
    assert rounds == ref_rounds >= 1
    assert_forest(got, ref)
    assert_forest(got, want)


# ---------------------------------------------------------------------------
# the device helpers the mesh calls, against the reference's
# ---------------------------------------------------------------------------


def test_links_from_parent_and_merge_parents():
    import jax.numpy as jnp
    from sheep_tpu.ops import forest as ref_forest
    from sheep_tpu_torch.ops import forest as port_forest

    tail, head = graph(17)
    seq = degree_sequence(tail, head)
    n = len(seq)
    parents, psts = [], []
    for k in range(3):
        sl = slice(k * len(tail) // 3, (k + 1) * len(tail) // 3)
        f = build_forest(tail[sl], head[sl], seq,
                         max_vid=int(max(tail.max(), head.max())))
        parents.append(np.where(f.parent == 0xFFFFFFFF, n,
                                f.parent.astype(np.int64)))
        psts.append(f.pst_weight.astype(np.int32))
    parents = np.stack(parents).astype(np.int32)
    psts = np.stack(psts)
    for a, b in zip(ref_forest.links_from_parent(jnp.asarray(parents[0]), n),
                    port_forest.links_from_parent(
                        torch.from_numpy(parents[0]), n)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = ref_forest.merge_parents(jnp.asarray(parents), jnp.asarray(psts),
                                   n)
    got = port_forest.merge_parents(torch.from_numpy(parents),
                                    torch.from_numpy(psts), n)
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    assert int(ref[2]) == got[2]


@pytest.mark.parametrize("subset", [False, True])
def test_build_and_merge_forests_device(subset):
    from sheep_tpu.ops import forest as ref_forest
    from sheep_tpu_torch.ops import build_forest_device, merge_forests_device

    tail, head = graph(23 + subset)
    seq = degree_sequence(tail, head)
    if subset:
        seq = seq[:-3]
    max_vid = int(max(tail.max(), head.max()))
    ref = ref_forest.build_forest_device(tail, head, seq, max_vid)
    got = build_forest_device(tail, head, seq, max_vid, device="cpu")
    assert_forest(got, ref)
    assert_forest(got, oracle(tail, head, seq)[1])
    half = len(tail) // 2
    parts = [ref_forest.build_forest_device(tail[s], head[s], seq, max_vid)
             for s in (slice(0, half), slice(half, None))]
    assert_forest(merge_forests_device(*parts, device="cpu"),
                  ref_forest.merge_forests_device(*parts))


def test_build_step_equals_reference():
    import jax.numpy as jnp
    from sheep_tpu.ops.build import build_step as ref_step
    from sheep_tpu_torch.ops import build_step

    tail, head = graph(29)
    n = int(max(tail.max(), head.max())) + 1
    ref = ref_step(jnp.asarray(tail.astype(np.int32)),
                   jnp.asarray(head.astype(np.int32)), n)
    got = build_step(torch.from_numpy(tail.astype(np.int32)),
                     torch.from_numpy(head.astype(np.int32)), n)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(
            np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


def test_device_helpers_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from sheep_tpu_torch.core.forest import Forest
    from sheep_tpu_torch.ops import build_forest_device, merge_forests_device

    tail = np.array([0, 1], np.uint32)
    head = np.array([1, 2], np.uint32)
    seq = np.array([0, 1, 2], np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_forest_device(tail, head, seq)
    f = Forest(np.array([1, 0xFFFFFFFF], np.uint32),
               np.zeros(2, np.uint32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        merge_forests_device(f, f)
