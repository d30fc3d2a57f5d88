"""The plain reference: a hand-worked graph, hep-th's published facts,
the two forest computations against each other, and (in these tests
only) the program's CPU paths."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from conftest import REPO
from harness import reference
from harness.graph import rmat_device

ROOT = reference.ROOT


def test_hand_worked_graph():
    """vids 0..5, records (0,1) (1,2) (2,0) (3,4) (4,4) (1,2) (5,3):
    degrees 0:2 1:4 2:4 3:2 4:4 5:1 (the self-loop counts twice), so
    seq = 5 0 3 1 2 4 and positions 5:0 0:1 3:2 1:3 2:4 4:5.  The
    self-loop links nothing; the links are
    (1,3) (3,4) (1,4) (2,5) (3,4) (0,2), so pst = [1, 2, 1, 2, 0, 0].
    Forest: 0->2, 1->3, 2->5, 3->4 (1 is already below 3 when 4 comes),
    4 and 5 roots."""
    tail = np.array([0, 1, 2, 3, 4, 1, 5], np.uint32)
    head = np.array([1, 2, 0, 4, 4, 2, 3], np.uint32)
    got = reference.expected(tail, head, 6, "cpu")
    assert got["seq"].tolist() == [5, 0, 3, 1, 2, 4]
    assert got["pst"].tolist() == [1, 2, 1, 2, 0, 0]
    assert got["parent"].tolist() == [2, 3, 5, 4, ROOT, ROOT]


def test_given_sequence_leaves_vids_out():
    """A vid the sequence leaves out links nothing and counts pst at the
    present endpoint; a record with both ends absent counts nowhere."""
    tail = np.array([0, 1, 2, 3], np.uint32)
    head = np.array([1, 3, 3, 3], np.uint32)
    got = reference.expected(tail, head, 4, "cpu",
                             seq=np.array([0, 1, 2], np.uint32))
    assert got["seq"].tolist() == [0, 1, 2]
    assert got["pst"].tolist() == [1, 1, 1]
    assert got["parent"].tolist() == [1, ROOT, ROOT]


def test_hep_th_published_facts():
    """hep-th (data/hep-th.dat: XS1 records of uint32 tail, uint32 head,
    float32 weight): the published TREEFAQS give verts:7610, roots:581,
    edges:15751."""
    xs1 = np.dtype([("tail", "<u4"), ("head", "<u4"), ("weight", "<f4")])
    recs = np.fromfile(os.path.join(REPO, "data", "hep-th.dat"), xs1)
    tail, head = recs["tail"].copy(), recs["head"].copy()
    vids = int(max(tail.max(), head.max())) + 1
    got = reference.expected(tail, head, vids, "cpu")
    assert len(got["seq"]) == 7610
    assert int((got["parent"] == ROOT).sum()) == 581
    assert int(got["pst"].sum()) == 15751


def _random_links(rng, n, m):
    a = rng.integers(0, n, m)
    b = rng.integers(0, n, m)
    keep = a != b
    return np.minimum(a, b)[keep], np.maximum(a, b)[keep]


@pytest.mark.parametrize("shape", ["random", "star", "chain", "rmat"])
@pytest.mark.parametrize("seed", range(4))
def test_lifting_equals_union_find(shape, seed):
    rng = np.random.default_rng(seed)
    n = 300
    if shape == "random":
        lo, hi = _random_links(rng, n, 900)
    elif shape == "star":  # hubs: one vid linked to many above it
        hubs = rng.integers(0, 20, 600)
        hi = rng.integers(20, n, 600)
        lo = hubs
    elif shape == "chain":  # a long path plus long chords
        lo = np.concatenate([np.arange(n - 1), rng.integers(0, n // 2, 50)])
        hi = np.concatenate([np.arange(1, n), rng.integers(n // 2, n, 50)])
    else:
        t, h = rmat_device(8, 2000, seed, "cpu")
        t, h = t.numpy(), h.numpy()
        keep = t != h
        lo, hi = np.minimum(t, h)[keep], np.maximum(t, h)[keep]
        n = 256
    want = reference.forest_union_find(lo, hi, n)
    got, _ = reference.forest_lifting(torch.from_numpy(lo.astype(np.int64)),
                                      torch.from_numpy(hi.astype(np.int64)), n)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3])
def test_reference_equals_program_cpu_paths(seed):
    """In a test only: the program's python oracle and its hybrid build
    on the CPU give the reference's seq, parent and pst."""
    from sheep_tpu_torch.core.forest import build_forest
    from sheep_tpu_torch.core.sequence import degree_sequence
    from sheep_tpu_torch.ops.build import build_graph_hybrid

    t, h = rmat_device(11, 1 << 14, seed, "cpu")
    tail = t.numpy().view(np.uint32)
    head = h.numpy().view(np.uint32)
    want = reference.expected(tail, head, 1 << 11, "cpu")
    seq = degree_sequence(tail, head, 1 << 11)
    oracle = build_forest(tail, head, seq, impl="python")
    assert np.array_equal(seq, want["seq"])
    assert np.array_equal(oracle.parent, want["parent"])
    assert np.array_equal(oracle.pst_weight, want["pst"])
    hseq, forest = build_graph_hybrid(tail, head, device="cpu")
    assert np.array_equal(hseq, want["seq"])
    assert np.array_equal(forest.parent, want["parent"])
    assert np.array_equal(forest.pst_weight, want["pst"])
