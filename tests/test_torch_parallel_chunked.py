"""The port's chunked mesh build (sheep_tpu_torch.parallel.chunked)
against the reference's, mirroring tests/test_parallel_chunked.py.

Both run the same seeded inputs, the reference on its 8-device virtual
CPU mesh and the port on W CPU workers (``parallel.mesh.mesh_devices``
patched), W in {1, 2, 3, 8}.  Equal, exactly: seq, parent and pst; the
``timings`` round counts (map and reduce, unified and split); the whole
collective-volume model ``comm`` (sharded global rounds, pmin and gather
payload bytes, tail rounds, the tail shard's columns), which also pins
the gather-tail decision and its knobs; the map-only route's per-worker
partials; the streamed build's rounds.
"""

import os

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
N, E = 64, 256


def graph(seed: int, n: int = N, e: int = E):
    """A random multigraph of e records over exactly n vertex ids (one
    shape for every draw, so the reference's programs are reused)."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    tail[0] = n - 1
    return tail, head


@pytest.fixture
def workers(monkeypatch):
    def use(w):
        monkeypatch.setattr(port_mesh, "mesh_devices",
                            lambda device: [CPU] * w)
    return use


def assert_forest(got, want):
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.pst_weight, want.pst_weight)


def both_links(tail, head, n, w, **kw):
    """build_links_chunked_sharded on both packages over the same staged
    records.  Returns {side: (outputs as numpy, timings, comm)}."""
    rmesh = ref_par.make_mesh(w)
    rt2, rh2 = ref_chunked.stage_edges_2d(tail, head, n, rmesh)
    pmesh = par.make_mesh(w, "cpu")
    pt2, ph2 = chunked.stage_edges_2d(tail, head, n, pmesh)
    out = {}
    for side, fn, args in (
            ("ref", ref_chunked.build_links_chunked_sharded,
             (rt2, rh2, n, rmesh)),
            ("port", chunked.build_links_chunked_sharded,
             (pt2, ph2, n, pmesh))):
        tm, comm = {}, {}
        res = fn(*args, timings=tm, comm=comm, **kw)
        out[side] = ([np.asarray(x) if side == "ref" else x.numpy()
                      for x in res], tm, comm)
    return out


def assert_same_run(out):
    (ref, rtm, rcomm), (got, ptm, pcomm) = out["ref"], out["port"]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    for key in ("map_rounds", "reduce_rounds", "unified"):
        assert ptm[key] == rtm[key], key
    assert pcomm == rcomm


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_chunked_links_equal_reference(workers, w, unified):
    workers(w)
    tail, head = graph(700 + w)
    assert_same_run(both_links(tail, head, N, w, unified=unified))


@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_chunked_equals_reference(workers, w):
    workers(w)
    tail, head = graph(800 + w)
    ref_seq, ref = ref_par.build_graph_chunked_distributed(
        tail, head, num_workers=w)
    tm = {}
    seq, forest = par.build_graph_chunked_distributed(
        tail, head, num_workers=w, device="cpu", timings=tm)
    np.testing.assert_array_equal(seq, ref_seq)
    assert_forest(forest, ref)
    want = build_forest(tail, head, degree_sequence(tail, head))
    assert_forest(forest, want)
    assert tm["unified"] and tm["map_rounds"] == 0
    assert len(tm["k1_by_worker"]) == w


@pytest.mark.parametrize("w", [2, 8])
def test_chunked_given_sequence(workers, w):
    """A given sequence over a SUBSET of the vids: absent vids count
    toward pst but never insert."""
    workers(w)
    tail, head = graph(9100 + w)
    full_seq = degree_sequence(tail, head)
    seq = full_seq[:max(2, len(full_seq) * 2 // 3)]
    ref_seq, ref = ref_par.build_graph_chunked_distributed(
        tail, head, num_workers=w, seq=seq)
    out_seq, forest = par.build_graph_chunked_distributed(
        tail, head, num_workers=w, seq=seq, device="cpu")
    np.testing.assert_array_equal(out_seq, ref_seq)
    assert_forest(forest, ref)
    want = build_forest(tail, head, seq,
                        max_vid=int(max(tail.max(), head.max())))
    assert_forest(forest, want)


def test_chunked_edges_fewer_than_workers(workers):
    workers(8)
    tail = np.array([0], dtype=np.uint32)
    head = np.array([1], dtype=np.uint32)
    seq, forest = par.build_graph_chunked_distributed(
        tail, head, num_workers=8, device="cpu")
    assert list(seq) == [0, 1]
    assert list(forest.parent) == [1, 0xFFFFFFFF]
    assert list(forest.pst_weight) == [1, 0]


def test_chunked_empty_graph(workers):
    workers(4)
    empty = np.empty(0, np.uint32)
    seq, forest = par.build_graph_chunked_distributed(
        empty, empty, num_workers=4, device="cpu")
    assert len(seq) == 0 and forest.n == 0
    seq, parts = par.map_graph_chunked_distributed(
        empty, empty, num_workers=4, device="cpu")
    assert len(seq) == 0 and parts == []


@pytest.mark.parametrize("w,block", [(8, 64), (3, 100), (1, 64)])
def test_chunked_streaming_equals_reference(workers, w, block):
    """The bounded-dispatch streaming fold: forest and total rounds."""
    from sheep_tpu.core.sequence import sequence_positions

    workers(w)
    tail, head = graph(3100 + w)
    seq = degree_sequence(tail, head)
    max_vid = int(max(tail.max(), head.max()))
    pos = sequence_positions(seq, max_vid)
    n = len(seq)

    def blocks():
        return ((tail[a:a + block], head[a:a + block])
                for a in range(0, len(tail), block))

    ref, ref_rounds = ref_par.build_graph_streaming_chunked(
        blocks(), n, pos, block_edges=block, num_workers=w)
    got, rounds = par.build_graph_streaming_chunked(
        blocks(), n, pos, block_edges=block, num_workers=w, device="cpu")
    assert rounds == ref_rounds >= 1
    assert_forest(got, ref)
    assert_forest(got, build_forest(tail, head, seq, max_vid=max_vid))


@pytest.mark.parametrize("w", [1, 2, 8])
def test_chunked_map_only_partials(workers, w, monkeypatch):
    """map_graph_chunked_distributed: each worker's partial (local rounds
    only, its own shard's pst) equals the reference's, and equals the
    port's loop twin's partial for partial."""
    workers(w)
    tail, head = graph(7500 + w)
    ref_seq, ref_parts = ref_par.map_graph_chunked_distributed(
        tail, head, num_workers=w)
    seq, parts = par.map_graph_chunked_distributed(
        tail, head, num_workers=w, device="cpu")
    np.testing.assert_array_equal(seq, ref_seq)
    assert len(parts) == w
    for a, b in zip(parts, ref_parts):
        assert_forest(a, b)
    monkeypatch.setenv("SHEEP_MESH_KERNEL", "loop")
    _, loop_parts = par.map_graph_distributed(tail, head, num_workers=w,
                                              device="cpu")
    for a, b in zip(parts, loop_parts):
        assert_forest(a, b)


def test_mesh_kernel_env_validation(monkeypatch):
    """A typo'd SHEEP_MESH_KERNEL raises, as the reference's does, and
    through the public wrappers too."""
    from sheep_tpu_torch.parallel.build import _mesh_kernel

    monkeypatch.setenv("SHEEP_MESH_KERNEL", "chunk")
    with pytest.raises(ValueError, match="SHEEP_MESH_KERNEL"):
        _mesh_kernel()
    tail, head = graph(1)
    with pytest.raises(ValueError, match="SHEEP_MESH_KERNEL"):
        par.map_graph_distributed(tail, head, device="cpu")
    monkeypatch.setenv("SHEEP_MESH_KERNEL", "loop")
    assert _mesh_kernel() == "loop"
    monkeypatch.delenv("SHEEP_MESH_KERNEL")
    assert _mesh_kernel() == "chunked"


# ---------------------------------------------------------------------------
# the gather-tail and its knobs
# ---------------------------------------------------------------------------


def _rmat(seed, log_n, factor):
    n = 1 << log_n
    tail, head = rmat_edges(log_n, factor * n, seed=seed)
    return tail, head, n


@pytest.mark.parametrize("arm", [
    dict(gather_tail=True, tail_shard=False),
    dict(gather_tail=False),
    dict()], ids=["gather", "no_gather", "default"])
def test_gather_tail_comm_model_equals_reference(workers, arm):
    """The gather decision (never before the first sharded chunk), the
    replicated tail's rounds and every byte of the comm model."""
    workers(8)
    tail, head, n = _rmat(78, 12, 8)
    out = both_links(tail, head, n, 8, **arm)
    assert_same_run(out)
    comm = out["port"][2]
    if arm.get("gather_tail", True):
        assert comm["gather_payload_bytes"] > 0 and comm["tail_rounds"] > 0
    else:
        assert comm["gather_payload_bytes"] == 0


@pytest.mark.parametrize("env", [
    {"SHEEP_MESH_GATHER_TAIL": "0"},
    {"SHEEP_MESH_GATHER_FACTOR": "0.5"},
    {"SHEEP_MESH_TAIL_SHARD": "0"}], ids=lambda e: "-".join(e))
def test_gather_knobs_equal_reference(workers, monkeypatch, env):
    workers(3)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tail, head, n = _rmat(79, 11, 4)
    assert_same_run(both_links(tail, head, n, 3))


def test_chunked_hepth_equals_reference(workers):
    """The golden graph at W = 8: forest, rounds and comm."""
    from sheep_tpu_torch.io import load_edges

    workers(8)
    el = load_edges(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "hep-th.dat"))
    n = int(max(el.tail.max(), el.head.max())) + 1
    out = both_links(el.tail, el.head, n, 8)
    assert_same_run(out)
    tm = out["port"][1]
    assert tm["unified"] and tm["map_rounds"] == 0
    assert tm["reduce_rounds"] >= 1 and tm["reduce_s"] > 0
