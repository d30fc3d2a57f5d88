"""The port's partitioner (sheep_tpu_torch.partition) equals sheep_tpu's on
the same seeded inputs: hep-th's published ECV(down) sweep and 2-part
report through the port, every strategy's parts on R-MAT forests, the
in-memory and streamed evaluators (more than 64 parts included), the
Partition writers byte for byte, and FENNEL."""

import contextlib
import io
import os

import numpy as np
import pytest

from conftest import random_multigraph

import sheep_tpu.partition as RP
from sheep_tpu.core import forest as RF
from sheep_tpu.core import sequence as RS
from sheep_tpu.partition import evaluate as RE
from sheep_tpu.partition import fennel as RFen
from sheep_tpu.partition import tree_partition as RT
from sheep_tpu.utils import rmat_edges

import sheep_tpu_torch.partition as PP
from sheep_tpu_torch import INVALID_PART
from sheep_tpu_torch.core import build_forest, degree_sequence
from sheep_tpu_torch.core import forest as PF
from sheep_tpu_torch.core.sequence import sequence_positions
from sheep_tpu_torch.io import load_edges
from sheep_tpu_torch.partition import evaluate as PE
from sheep_tpu_torch.partition import fennel as PFen
from sheep_tpu_torch.partition import tree_partition as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")
#: the reference's published sweep (data/hepth-ecv-baseline.json)
PUBLISHED = dict(zip(range(2, 10),
                     (521, 888, 1177, 1342, 1532, 1661, 1818, 1922)))
STRATEGIES = ("forward", "backward", "depth", "height", "naive")


@pytest.fixture(scope="module")
def hep():
    el = load_edges(HEP)
    seq = degree_sequence(el.tail, el.head)
    return el, seq, build_forest(el.tail, el.head, seq)


def _printed(obj, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        obj.print(*args)
    return buf.getvalue()


def test_hepth_baseline_file_is_the_published_sweep():
    import json
    with open(os.path.join(REPO, "data", "hepth-ecv-baseline.json")) as f:
        base = json.load(f)["ecv_down"]
    assert {int(k): v for k, v in base.items()} == PUBLISHED


@pytest.mark.parametrize("parts", range(2, 10))
def test_hepth_published_ecv_down(hep, parts):
    """ECV(down) at 2..9 parts through the port equals the published
    sweep and the reference's own report, field for field."""
    el, seq, forest = hep
    p = PP.Partition.from_forest(seq, forest, parts, max_vid=el.max_vid)
    rep = PP.evaluate_partition(p.parts, el.tail, el.head, seq, parts,
                                max_vid=el.max_vid, file_edges=el.num_edges)
    assert rep.ecv_down == PUBLISHED[parts]
    rseq = RS.degree_sequence(el.tail, el.head)
    rforest = RF.build_forest(el.tail, el.head, rseq)
    rp = RP.Partition.from_forest(rseq, rforest, parts, max_vid=el.max_vid)
    np.testing.assert_array_equal(p.parts, rp.parts)
    rrep = RP.evaluate_partition(rp.parts, el.tail, el.head, rseq, parts,
                                 max_vid=el.max_vid,
                                 file_edges=el.num_edges)
    assert vars(rep) == vars(rrep)


def test_hepth_bipartition_report(hep):
    """The full 2-part report of the published run, and its printed
    lines equal to the reference's."""
    el, seq, forest = hep
    p = PP.Partition.from_forest(seq, forest, 2, max_vid=el.max_vid)
    assert [(p.parts == 0).sum(), (p.parts == 1).sum()] == [3409, 4201]
    rep = PP.evaluate_partition(p.parts, el.tail, el.head, seq, 2,
                                max_vid=el.max_vid, file_edges=el.num_edges)
    assert (rep.edges_cut, rep.vcom_vol, rep.ecv_hash, rep.ecv_down,
            rep.ecv_up) == (2811, 2061, 1311, 521, 1539)
    rp = RP.Partition(p.parts, 2)
    assert _printed(p) == _printed(rp) == (
        "Actually created 2 partitions.\n"
        "First two partition sizes: 3409 and 4201\n")
    rrep = RE.EvalReport(**vars(rep))
    for with_seq in (True, False):
        assert _printed(rep, with_seq) == _printed(rrep, with_seq)
    assert "ECV(down): 521 (" in _printed(rep)


def _rmat_forest(seed, log_n=10):
    tail, head = rmat_edges(log_n, 6 << log_n, seed=seed)
    seq = RS.degree_sequence(tail, head)
    return tail, head, seq, RF.build_forest(tail, head, seq)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", range(3))
def test_strategies_equal_reference(strategy, seed):
    """Every strategy's jnid parts on seeded R-MAT forests equal the
    reference's; the forward pass under impl auto (native) and python
    agree, with pst, vertex and pre weights."""
    tail, head, seq, forest = _rmat_forest(300 + seed)
    pre = RF.pre_weights(tail, head, seq)
    opts = [PT.TreePartitionOptions(),
            PT.TreePartitionOptions(vtx_weight=True, balance_factor=1.1),
            PT.TreePartitionOptions(pst_weight=False, vtx_weight=True,
                                    pre_weight=True)]
    pforest = PF.Forest(forest.parent, forest.pst_weight)
    for o in opts:
        ro = RT.TreePartitionOptions(**vars(o))
        _eq = np.testing.assert_array_equal
        _eq(PT.node_weights(pforest, o, pre),
            RT.node_weights(forest, ro, pre))
        for parts in (2, 16, 64):
            try:
                want = RT.partition_forest(forest, parts, ro, strategy,
                                           pre=pre, impl="python")
            except ValueError:  # a node outweighs a part: both refuse
                want = None
            for impl in ("auto", "python"):
                if want is None:
                    with pytest.raises(ValueError, match="heaviest node"):
                        PT.partition_forest(pforest, parts, o, strategy,
                                            pre=pre, impl=impl)
                    continue
                got = PT.partition_forest(pforest, parts, o, strategy,
                                          pre=pre, impl=impl)
                assert got.dtype == np.int64
                _eq(got, want)


@pytest.mark.parametrize("seed", range(2))
def test_partition_container_equals_reference(tmp_path, seed):
    """from_forest for each strategy, from_file, and both writers: the
    same parts and the same bytes (sidecars included) as the
    reference's."""
    tail, head, seq, forest = _rmat_forest(320 + seed, log_n=9)
    mv = int(max(tail.max(), head.max()))
    pforest = PF.Forest(forest.parent, forest.pst_weight)
    for strategy in STRATEGIES:
        got = PP.Partition.from_forest(seq, pforest, 5, strategy=strategy,
                                       max_vid=mv + 2)
        want = RP.Partition.from_forest(seq, forest, 5, strategy=strategy,
                                        max_vid=mv + 2)
        np.testing.assert_array_equal(got.parts, want.parts)
        assert got.num_parts == want.num_parts and got.max_part == \
            want.max_part
    jfile = tmp_path / "parts.txt"
    np.savetxt(jfile, PT.partition_forest(pforest, 4), fmt="%d")
    a = PP.Partition.from_file(seq, str(jfile))
    b = RP.Partition.from_file(seq, str(jfile))
    np.testing.assert_array_equal(a.parts, b.parts)
    assert a.num_parts == b.num_parts
    for fmt in ("net", "dat"):
        pa = got.write_partitioned_graph(tail, head, seq,
                                         str(tmp_path / f"p-{fmt}-"),
                                         max_vid=mv, fmt=fmt)
        ra = want.write_partitioned_graph(tail, head, seq,
                                          str(tmp_path / f"r-{fmt}-"),
                                          max_vid=mv, fmt=fmt)
        assert len(pa) == len(ra) == want.max_part + 1
        for x, y in zip(pa, ra):
            for suffix in ("", ".sum"):
                with open(x + suffix, "rb") as fx, \
                        open(y + suffix, "rb") as fy:
                    assert fx.read() == fy.read()
    got.write_isomorphic_graph(tail, head, seq, str(tmp_path / "p.net"),
                               max_vid=mv)
    want.write_isomorphic_graph(tail, head, seq, str(tmp_path / "r.net"),
                                max_vid=mv)
    assert (tmp_path / "p.net").read_bytes() == \
        (tmp_path / "r.net").read_bytes()


def test_downward_assignment_covers_every_edge_once(tmp_path, hep):
    el, seq, forest = hep
    p = PP.Partition.from_forest(seq, forest, 2, max_vid=el.max_vid)
    paths = p.write_partitioned_graph(el.tail, el.head, seq,
                                      str(tmp_path / "out-p"),
                                      max_vid=el.max_vid)
    rows = sum(len(open(path).read().splitlines()) for path in paths)
    assert rows == el.num_edges - int((el.tail == el.head).sum())


def test_helpers_equal_reference():
    tail, head, seq, forest = _rmat_forest(340, log_n=8)
    for a, b in zip(PT.make_kids(forest.parent), RT.make_kids(forest.parent)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PT.random_partition(500, 7, seed=3),
                                  RT.random_partition(500, 7, seed=3))
    k = np.arange(1000, dtype=np.uint32) * 7919
    np.testing.assert_array_equal(PE.cormen_hash(k), RE.cormen_hash(k))


def test_forward_overweight_node_raises():
    tail = np.array([0, 1], dtype=np.uint32)
    head = np.array([1, 2], dtype=np.uint32)
    seq = degree_sequence(tail, head)
    forest = build_forest(tail, head, seq)
    for impl in ("auto", "python"):
        with pytest.raises(ValueError, match="max_component"):
            PT.partition_forest(forest, 8, impl=impl)


@pytest.mark.parametrize("seed", range(6))
def test_evaluator_equals_reference(seed):
    """Random multigraphs with self-loops and absent vids (INVALID_PART
    where a vid has no position), with and without a sequence."""
    rng = np.random.default_rng(9000 + seed)
    tail, head = random_multigraph(rng, n_max=200, e_max=900)
    seq = RS.degree_sequence(tail, head)
    n = int(max(tail.max(), head.max())) + 1
    parts = np.full(n + 4, INVALID_PART, dtype=np.int64)
    parts[seq] = rng.integers(0, 5, size=len(seq))
    for s in (seq, None):
        got = PE.evaluate_partition(parts, tail, head, s, 5, max_vid=n + 3,
                                    file_edges=len(tail) + 2)
        want = RE.evaluate_partition(parts, tail, head, s, 5, max_vid=n + 3,
                                     file_edges=len(tail) + 2)
        assert vars(got) == vars(want)


@pytest.mark.parametrize("table", [True, False])
def test_distinct_pair_count_table_and_sort_agree(monkeypatch, table):
    """The evaluator's distinct-pair count through its key table and
    through the sort it keeps for key spaces past the table's cap."""
    if not table:
        monkeypatch.setattr(PE, "_KEY_TABLE_BYTES", 0)
    rng = np.random.default_rng(77)
    for card, n in ((1, 50), (3, 400), (100, 300)):
        x = rng.integers(0, n, 5000)
        y = rng.integers(0, card, 5000)
        want = len({(a, b) for a, b in zip(x.tolist(), y.tolist())})
        assert PE._nunique_pairs(x, y, card) == want
    assert PE._nunique_pairs(np.empty(0, np.int64), np.empty(0, np.int64),
                             4) == 0
    tail, head, seq, forest = _rmat_forest(360, log_n=9)
    parts = RT.partition_forest(forest, 9)
    vparts = np.full(int(max(tail.max(), head.max())) + 1, INVALID_PART)
    vparts[seq] = parts
    assert vars(PE.evaluate_partition(vparts, tail, head, seq, 9)) == \
        vars(RE.evaluate_partition(vparts, tail, head, seq, 9))


@pytest.mark.parametrize("impl", ["auto", "python"])
@pytest.mark.parametrize("num_parts", [2, 7, 100])
def test_streamed_evaluator_equals_in_memory(num_parts, impl):
    """The O(n)-memory bitmap evaluator equals the dense one and the
    reference's streamed one, past 64 parts (several windows) too, with
    and without a sequence, through the native block and the numpy
    body."""
    rng = np.random.default_rng(42 + num_parts)
    n, e = 300, 1500
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    seq = RS.degree_sequence(tail, head)
    parts = rng.integers(0, num_parts, n).astype(np.int64)
    pos = sequence_positions(seq, n - 1).astype(np.int64)

    def blocks():
        for a in range(0, e, 64):
            yield tail[a:a + 64], head[a:a + 64]

    for s, p in ((seq, pos), (None, None)):
        dense = PE.evaluate_partition(parts, tail, head, s, num_parts,
                                      max_vid=n - 1, file_edges=e)
        stream = PE.evaluate_partition_streamed(parts, blocks, p, num_parts,
                                                e, impl=impl)
        ref = RE.evaluate_partition_streamed(
            parts, blocks, p, num_parts, e,
            impl="python" if impl == "python" else "native")
        assert vars(dense) == vars(stream) == vars(ref)


def test_streamed_evaluator_rejects_uncovered_vid():
    tail = np.array([0, 1], np.uint32)
    head = np.array([1, 2], np.uint32)
    parts = np.array([0, INVALID_PART, 1], np.int64)
    pos = np.array([0, 1, 2], np.int64)
    with pytest.raises(ValueError, match="invalid part"):
        PE.evaluate_partition_streamed(parts, lambda: iter([(tail, head)]),
                                       pos, 2, 2)


@pytest.mark.parametrize("num_parts,eb", [(2, True), (2, False), (5, True),
                                          (7, False), (70, True)])
def test_fennel_vertex_equals_reference(num_parts, eb):
    rng = np.random.default_rng(800 + num_parts)
    n, e = 120, 600
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    want = RFen.fennel_vertex(tail, head, num_parts, edge_balanced=eb,
                              impl="python")
    for impl in ("auto", "python"):
        np.testing.assert_array_equal(
            PFen.fennel_vertex(tail, head, num_parts, edge_balanced=eb,
                               impl=impl), want)


@pytest.mark.parametrize("num_parts", [2, 5, 70])
def test_fennel_edges_equals_reference(num_parts):
    rng = np.random.default_rng(850 + num_parts)
    n, e = 120, 600
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    want = RFen.fennel_edges(tail, head, num_parts, impl="python")
    for impl in ("auto", "python"):
        np.testing.assert_array_equal(
            PFen.fennel_edges(tail, head, num_parts, impl=impl), want)
    assert PFen.fennel_edges(tail[:0], head[:0], 3).shape == (0,)


def test_fennel_without_sequence_evaluates_like_reference():
    rng = np.random.default_rng(31)
    tail, head = random_multigraph(rng, n_max=30, e_max=100)
    parts = PFen.fennel_vertex(tail, head, 2)
    active = (np.bincount(tail, minlength=len(parts))
              + np.bincount(head, minlength=len(parts))) > 0
    assert (parts[~active] == INVALID_PART).all()
    rep = PE.evaluate_partition(parts, tail, head, None, 2)
    assert rep.ecv_down == 0 and rep.ecv_up == 0
    assert vars(rep) == vars(RE.evaluate_partition(parts, tail, head, None,
                                                   2))
