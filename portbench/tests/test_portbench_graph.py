"""The benchmark's graph generator: determinism per seed, the Graph500
quadrant shares, the label permutation."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from harness.graph import make_graph, rmat_device

SPEC = {"generator": "graph500_kronecker", "log_vid_slots": 12,
        "records": 1 << 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "permute_labels": True}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1])
def test_same_seed_same_records(seed):
    g1 = make_graph(SPEC, seed, "cpu")
    g2 = make_graph(SPEC, seed, "cpu")
    assert g1.tail.dtype == np.uint32 and g1.head.dtype == np.uint32
    assert len(g1.tail) == SPEC["records"] == g1.records
    assert np.array_equal(g1.tail, g2.tail)
    assert np.array_equal(g1.head, g2.head)
    assert g1.tail.max() < 1 << 12 and g1.head.max() < 1 << 12


def test_other_seed_other_records():
    g1 = make_graph(SPEC, 1, "cpu")
    g2 = make_graph(SPEC, 2, "cpu")
    assert not np.array_equal(g1.tail, g2.tail)


def test_quadrant_shares():
    """Unpermuted, each bit of a record falls in quadrant A, B, C, D with
    0.57, 0.19, 0.19, 0.05: tail's bit set in C and D, head's in B and
    D."""
    records = 1 << 18
    tail, head = rmat_device(8, records, 3, "cpu", permute=False)
    shares = {"A": 0, "B": 0, "C": 0, "D": 0}
    for bit in range(8):
        tb = ((tail >> bit) & 1).bool()
        hb = ((head >> bit) & 1).bool()
        shares["A"] += int((~tb & ~hb).sum())
        shares["B"] += int((~tb & hb).sum())
        shares["C"] += int((tb & ~hb).sum())
        shares["D"] += int((tb & hb).sum())
    total = 8 * records
    for q, p in {"A": 0.57, "B": 0.19, "C": 0.19, "D": 0.05}.items():
        assert abs(shares[q] / total - p) < 0.003, (q, shares[q] / total)


def test_permutation_relabels_only():
    """The permutation is a bijection of the vid slots: the degree
    multiset and the duplicates and self-loops are those of the
    unpermuted graph drawn from the same seed."""
    t0, h0 = rmat_device(10, 1 << 14, 11, "cpu", permute=False)
    t1, h1 = rmat_device(10, 1 << 14, 11, "cpu", permute=True)
    deg0 = torch.bincount(t0, minlength=1024) \
        + torch.bincount(h0, minlength=1024)
    deg1 = torch.bincount(t1, minlength=1024) \
        + torch.bincount(h1, minlength=1024)
    assert torch.equal(torch.sort(deg0).values, torch.sort(deg1).values)
    assert int((t0 == h0).sum()) == int((t1 == h1).sum()) > 0
    assert not torch.equal(t0, t1)


def test_unknown_generator_refused():
    with pytest.raises(ValueError):
        make_graph({**SPEC, "generator": "erdos"}, 0, "cpu")
