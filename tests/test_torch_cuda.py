"""The port on the card: kernel K1 against its plain version, and the
CUDA builds against the port's host oracle.

Marked ``cuda``; each test skips without a CUDA device (K1 is a CUDA
kernel with no CPU or interpret mode).  This file imports no jax, so it
runs on the GPU machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sheep_tpu_torch.core import build_forest, degree_sequence
from sheep_tpu_torch.ops import fused_jump as pj
from sheep_tpu_torch.ops.build import build_graph_device, build_graph_hybrid
from sheep_tpu_torch.ops.forest import min_up_table
from sheep_tpu_torch.utils import rmat_edges

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _links(trial):
    """The draws of tests/test_pallas_jump.py (seeds 600-605)."""
    rng = np.random.default_rng(600 + trial)
    n = int(rng.integers(50, 4000))
    e = int(rng.integers(10, 20000))
    lo = rng.integers(0, n, e)
    hi = np.minimum(lo + rng.integers(1, n, e), n)
    dead = rng.random(e) < 0.2
    lo[dead] = n
    hi[dead] = n
    return n, lo.astype(np.int32), hi.astype(np.int32), \
        int(rng.integers(1, 11))


@pytest.mark.parametrize("trial", range(6))
def test_k1_launch_equals_plain(cuda, trial):
    n, lo_np, hi_np, levels = _links(trial)
    lo = torch.from_numpy(lo_np).to(cuda)
    hi = torch.from_numpy(hi_np).to(cuda)
    f = min_up_table(lo, hi, n)
    before = pj.launches
    got_lo, got_moved = pj.fused_descend(lo, hi, n, levels, f)
    torch.cuda.synchronize()
    assert pj.launches == before + 1
    want_lo, want_moved = pj.fused_descend_plain(lo, hi, n, levels, f)
    assert torch.equal(got_lo, want_lo)
    assert int(got_moved) == int(want_moved)


def test_k1_ragged_tail_and_empty(cuda):
    n = 1 << 16
    e = 100_003  # not a multiple of any block size
    g = torch.Generator(device=cuda).manual_seed(3)
    lo = torch.randint(0, n, (e,), generator=g, device=cuda)
    hi = torch.clamp(lo + torch.randint(1, n, (e,), generator=g,
                                        device=cuda), max=n)
    lo, hi = lo.to(torch.int32), hi.to(torch.int32)
    tables = pj.lift_tables(min_up_table(lo, hi, n), 12)
    assert torch.equal(pj.jump_group_cuda(tables, lo, hi),
                       pj.jump_group_plain(tables, lo, hi))
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    assert pj.jump_group_cuda(tables, empty, empty).numel() == 0


@pytest.mark.parametrize("build", [build_graph_hybrid, build_graph_device])
def test_cuda_build_equals_oracle(cuda, build):
    tail, head = rmat_edges(14, 8 << 14, seed=5)
    want_seq = degree_sequence(tail, head)
    want = build_forest(tail, head, want_seq)
    pj.launches = 0
    seq, forest = build(tail, head)  # device None: the card
    assert pj.launches > 0
    np.testing.assert_array_equal(seq, want_seq)
    np.testing.assert_array_equal(forest.parent, want.parent)
    np.testing.assert_array_equal(forest.pst_weight, want.pst_weight)
