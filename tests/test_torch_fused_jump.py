"""Kernel K1 of the port (sheep_tpu_torch/ops/fused_jump.py) against the
JAX package's Pallas kernel and jnp descent.

On the CPU the port's descent is K1's plain torch version; the six cases
of tests/test_pallas_jump.py (seeds 600-605, 20% sentinels, levels 1-10)
must give exactly the lo and moved count of sheep_tpu's
``fused_jump(..., interpret=True)`` and ``ops.forest._jump``.  The CUDA
kernel itself runs only on the card: tests/test_torch_cuda.py holds it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sheep_tpu.ops import pallas_jump as ref_pj
from sheep_tpu.ops.forest import _jump as ref_jump
from sheep_tpu.ops.forest import min_up_table as ref_min_up_table

from sheep_tpu_torch.ops import fused_jump as pj
from sheep_tpu_torch.ops.forest import min_up_table


def _case(trial):
    """The exact draws of test_pallas_jump.py::test_fused_jump_equals_jnp."""
    rng = np.random.default_rng(600 + trial)
    n = int(rng.integers(50, 4000))
    e = int(rng.integers(10, 20000))
    lo_np = rng.integers(0, n, e)
    hi_np = np.minimum(lo_np + rng.integers(1, n, e), n)
    dead = rng.random(e) < 0.2
    lo_np[dead] = n
    hi_np[dead] = n
    levels = int(rng.integers(1, 11))
    return n, lo_np.astype(np.int32), hi_np.astype(np.int32), levels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("trial", range(6))
def test_fused_descend_equals_pallas_and_jnp(trial):
    n, lo_np, hi_np, levels = _case(trial)
    lo, hi = jnp.asarray(lo_np), jnp.asarray(hi_np)
    want_lo, want_moved = ref_jump(lo, hi, n, levels)
    pal_lo, pal_moved = ref_pj.fused_jump(lo, hi, n, levels, interpret=True)
    f = min_up_table(_t(lo_np), _t(hi_np), n)
    got_lo, got_moved = pj.fused_descend(_t(lo_np), _t(hi_np), n, levels, f)
    assert got_lo.dtype == torch.int32 and got_moved.dtype == torch.int32
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(pal_lo))
    assert int(got_moved) == int(want_moved) == int(pal_moved)


@pytest.mark.parametrize("trial", range(6))
def test_plain_and_self_contained_forms_agree(trial):
    n, lo_np, hi_np, levels = _case(trial)
    f = min_up_table(_t(lo_np), _t(hi_np), n)
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(ref_min_up_table(lo_np, hi_np, n)))
    a_lo, a_moved = pj.fused_descend_plain(_t(lo_np), _t(hi_np), n,
                                           levels, f)
    b_lo, b_moved = pj.fused_jump(_t(lo_np), _t(hi_np), n, levels)
    want_lo, want_moved = ref_pj.fused_jump(
        jnp.asarray(lo_np), jnp.asarray(hi_np), n, levels, interpret=True)
    for got_lo, got_moved in ((a_lo, a_moved), (b_lo, b_moved)):
        np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))
        assert int(got_moved) == int(want_moved)


@pytest.mark.parametrize("levels", [1, 2, 5, 11])
def test_lift_tables_deepest_first(levels):
    rng = np.random.default_rng(610 + levels)
    n = 3000
    lo = rng.integers(0, n, 8000).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, 50, 8000), n).astype(np.int32)
    f = min_up_table(_t(lo), _t(hi), n)
    tables = pj.lift_tables(f, levels)
    assert tables.shape == (levels, n + 1) and tables.is_contiguous()
    # the reference squares f in jnp: tables[k] = f^(2^(levels-1-k))
    want = [jnp.asarray(f.numpy())]
    for _ in range(levels - 1):
        want.append(want[-1][want[-1]])
    for k, w in enumerate(reversed(want)):
        np.testing.assert_array_equal(tables[k].numpy(), np.asarray(w))


def test_jump_group_uses_plain_version_on_cpu():
    n, lo_np, hi_np, levels = _case(0)
    f = min_up_table(_t(lo_np), _t(hi_np), n)
    tables = pj.lift_tables(f, levels)
    before = pj.launches
    out = pj.jump_group(tables, _t(lo_np), _t(hi_np))
    assert pj.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(
        out.numpy(), pj.jump_group_plain(tables, _t(lo_np), _t(hi_np)).numpy())


def test_cuda_wrapper_rejects_cpu_tensors():
    tables = torch.zeros((2, 9), dtype=torch.int32)
    lo = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pj.jump_group_cuda(tables, lo, lo.clone())


@pytest.mark.parametrize("bad", ["lo_dtype", "hi_dtype", "tables_dtype",
                                 "lo_strided", "tables_strided", "shape",
                                 "tables_1d"])
def test_wrappers_reject_bad_input(bad):
    tables = torch.zeros((2, 9), dtype=torch.int32)
    lo = torch.zeros(6, dtype=torch.int32)
    hi = torch.ones(6, dtype=torch.int32)
    if bad == "lo_dtype":
        lo = lo.long()
    elif bad == "hi_dtype":
        hi = hi.to(torch.int16)
    elif bad == "tables_dtype":
        tables = tables.long()
    elif bad == "lo_strided":
        lo = torch.zeros(12, dtype=torch.int32)[::2]
    elif bad == "tables_strided":
        tables = torch.zeros((9, 2), dtype=torch.int32).t()
    elif bad == "shape":
        hi = torch.ones(5, dtype=torch.int32)
    elif bad == "tables_1d":
        tables = torch.zeros(9, dtype=torch.int32)
    for fn in (pj.jump_group_cuda, pj.jump_group):
        with pytest.raises((TypeError, ValueError)):
            fn(tables, lo, hi)
