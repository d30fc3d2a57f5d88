"""The port's host layers (core/, native/, io/, utils/, convert) equal
sheep_tpu's on the same inputs."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from conftest import random_multigraph

import sheep_tpu.core as RC
from sheep_tpu.io import edges as RIO
from sheep_tpu.utils import rmat_edges as ref_rmat

import sheep_tpu_torch.core as PC
from sheep_tpu_torch import convert, native
from sheep_tpu_torch.io import edges as PIO
from sheep_tpu_torch.utils import rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")


def _forest_eq(got, want):
    assert got.parent.dtype == np.uint32 and got.pst_weight.dtype == np.uint32
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.pst_weight, want.pst_weight)


@pytest.mark.parametrize("log_n,e,seed", [(10, 5000, 0), (12, 1 << 14, 3),
                                          (17, 1 << 15, 9)])
def test_rmat_edges_same_arrays(log_n, e, seed):
    t, h = rmat_edges(log_n, e, seed=seed)
    rt, rh = ref_rmat(log_n, e, seed=seed)
    assert t.dtype == np.uint32
    np.testing.assert_array_equal(t, rt)
    np.testing.assert_array_equal(h, rh)


@pytest.mark.parametrize("trial", range(10))
def test_degree_sequence_and_positions(trial):
    rng = np.random.default_rng(6000 + trial)
    tail, head = random_multigraph(rng, 300, 2000)
    seq = PC.degree_sequence(tail, head)
    np.testing.assert_array_equal(seq, RC.degree_sequence(tail, head))
    np.testing.assert_array_equal(
        PC.sequence_positions(seq, 400), RC.sequence_positions(seq, 400))
    deg = np.bincount(tail, minlength=300) + np.bincount(head, minlength=300)
    from sheep_tpu.core.sequence import degree_sequence_from_degrees
    np.testing.assert_array_equal(
        PC.degree_sequence_from_degrees(deg),
        degree_sequence_from_degrees(deg, impl="python"))


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("trial", range(8))
def test_build_forest_oracle(trial, subset):
    rng = np.random.default_rng(6100 + trial)
    tail, head = random_multigraph(rng, 200, 1200)
    seq = RC.degree_sequence(tail, head)
    if subset:
        seq = seq[: max(2, len(seq) * 2 // 3)]
    mv = int(max(tail.max(), head.max()))
    lo, hi = PC.edges_to_positions(tail, head, seq, mv)
    rlo, rhi = RC.edges_to_positions(tail, head, seq, mv)
    np.testing.assert_array_equal(lo, rlo)
    np.testing.assert_array_equal(hi, rhi)
    _forest_eq(PC.build_forest(tail, head, seq, max_vid=mv),
               RC.build_forest(tail, head, seq, max_vid=mv, impl="python"))


@pytest.mark.parametrize("with_pst", [False, True])
@pytest.mark.parametrize("trial", range(5))
def test_host_fold_equals_reference_native(trial, with_pst):
    from sheep_tpu import native as ref_native

    rng = np.random.default_rng(6200 + trial)
    n = int(rng.integers(50, 3000))
    m = int(rng.integers(1, 20000))
    lo = rng.integers(0, n - 1, m)
    hi = lo + rng.integers(1, n, m)  # some hi >= n: pst-only links
    lo, hi = lo.astype(np.uint32), hi.astype(np.uint32)
    pst = rng.integers(0, 9, n).astype(np.uint32) if with_pst else None
    got = native.build_forest_links(lo, hi, n, pst)
    want = ref_native.build_forest_links(lo, hi, n, pst)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_host_fold_rejects_malformed_links():
    with pytest.raises(RuntimeError, match="rc=-3"):
        native.build_forest_links(np.array([5], np.uint32),
                                  np.array([6], np.uint32), 4)


def test_read_dat_and_partial_loads():
    el = PIO.load_edges(HEP)
    ref = RIO.load_edges(HEP, integrity="trust")
    np.testing.assert_array_equal(el.tail, ref.tail)
    np.testing.assert_array_equal(el.head, ref.head)
    assert el.file_edges == ref.file_edges and el.max_vid == ref.max_vid
    for part in (1, 2, 3):
        p = PIO.read_dat(HEP, part, 3)
        r = RIO.read_dat(HEP, part, 3, integrity="trust")
        np.testing.assert_array_equal(p.tail, r.tail)
        assert (p.start, p.file_edges) == (r.start, r.file_edges)


def test_read_net_and_dedup(tmp_path):
    path = tmp_path / "g.net"
    path.write_text("# comment\n0 1\n1 2\n2 2\n1 0\n 7 3\n")
    for part, num in ((0, 0), (1, 2), (2, 2)):
        p = PIO.read_net(str(path), part, num)
        r = RIO.read_net(str(path), part, num, integrity="trust")
        np.testing.assert_array_equal(p.tail, r.tail)
        np.testing.assert_array_equal(p.head, r.head)
        assert (p.start, p.file_edges) == (r.start, r.file_edges)
    p = PIO.load_edges(str(path), dedup=True)
    r = RIO.load_edges(str(path), dedup=True, integrity="trust")
    np.testing.assert_array_equal(p.tail, r.tail)
    np.testing.assert_array_equal(p.head, r.head)
    bad = tmp_path / "bad.net"
    bad.write_text("0 1\n2\n")
    with pytest.raises(ValueError):
        PIO.read_net(str(bad))


def test_hepth_facts_print_golden_line():
    el = PIO.load_edges(HEP)
    seq = PC.degree_sequence(el.tail, el.head)
    facts = PC.compute_facts(PC.build_forest(el.tail, el.head, seq))
    ref_seq = RC.degree_sequence(el.tail, el.head)
    ref_facts = RC.compute_facts(RC.build_forest(el.tail, el.head, ref_seq))
    outs = []
    for f in (facts, ref_facts):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            f.print()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0] == ("TREEFAQS: width:24\troots:581\n"
                       "\tvheight:754\teheight:2330\n"
                       "\tverts:7610\tedges:15751\n"
                       "\thalo:3532\tcore:0\n\tfill:0\n")


def test_convert_round_trips():
    from sheep_tpu.core.forest import Forest as RefForest

    rng = np.random.default_rng(6300)
    tail, head = random_multigraph(rng, 200, 1200)
    t, h = convert.edges_to_device(tail, head, "cpu")
    assert t.dtype == torch.int32
    rt, rh = convert.edges_from_device(t, h)
    np.testing.assert_array_equal(rt, tail)
    np.testing.assert_array_equal(rh, head)
    seq = RC.degree_sequence(tail, head)
    np.testing.assert_array_equal(
        convert.sequence_from_device(convert.sequence_to_device(seq, "cpu")),
        seq)
    ref = RC.build_forest(tail, head, seq, impl="python")
    assert isinstance(ref, RefForest)
    assert (ref.parent == 0xFFFFFFFF).any()  # roots survive the int32 view
    parent, pst = convert.forest_to_device(ref, "cpu")
    back = convert.forest_from_device(parent, pst)
    assert isinstance(back, PC.Forest)
    _forest_eq(back, ref)
    # the tensors are copies: writing them leaves the numpy arrays alone
    before = ref.parent.copy()
    parent.fill_(7)
    np.testing.assert_array_equal(ref.parent, before)
