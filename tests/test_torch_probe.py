"""The backend probe's kernels P1 and P2 (sheep_tpu_torch/ops/probe.py):
their plain versions equal the JAX package's functions exactly (jnp, the
probe's Pallas bodies in interpret mode, and the reference's own
``jump_group`` with one table), the CUDA wrappers refuse CPU tensors, and
the probe tool (python -m sheep_tpu_torch.scripts.kernel_probe) runs on
the CPU and exits 1 on a failure."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sheep_tpu.ops.pallas_jump import jump_group

from sheep_tpu_torch.ops import probe
from sheep_tpu_torch.scripts import kernel_probe


def _add_one_kernel(x_ref, o_ref):
    """Stage 1's Pallas body (scripts/pallas_probe.py:37-38)."""
    o_ref[...] = x_ref[...] + 1


def _recipe(n, seed=0, lo_over=0):
    """scripts/pallas_probe.py:53-57's inputs; ``lo_over`` > 0 draws lo
    past the table to pin the clamp."""
    rng = np.random.default_rng(seed)
    f = np.minimum(np.arange(n) + rng.integers(1, 64, n), n - 1)
    lo = rng.integers(0, n + lo_over, n)
    hi = np.minimum(lo + rng.integers(1, 1024, n), n + lo_over)
    return [a.astype(np.int32) for a in (f, lo, hi)]


@pytest.mark.parametrize("log_n", [10, 12, 14])
def test_add_one_plain_equals_jnp_and_pallas(log_n):
    n = 1 << log_n
    x = np.arange(n, dtype=np.int32).reshape(n // 256, 256)
    x[0, :4] = np.iinfo(np.int32).max  # wraps in all three
    got = probe.add_one_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x) + 1))
    pallas = pl.pallas_call(
        _add_one_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("lo_over", [0, 37])
@pytest.mark.parametrize("log_n", [10, 12, 14])
def test_jump_step_plain_equals_reference_jump(log_n, lo_over):
    """P2's plain version against the reference's jump_group with one
    table (P2's function, interpret mode) and the probe's jnp formula, on
    the probe's input recipe; ``lo_over`` puts lo past the table."""
    n = 1 << log_n
    f, lo, hi = _recipe(n, seed=log_n, lo_over=lo_over)
    assert lo_over == 0 or (lo >= n).any()
    got = probe.jump_step_plain(*map(torch.from_numpy, (f, lo, hi)))
    fj, loj, hij = map(jnp.asarray, (f, lo, hi))
    want = jump_group((fj,), loj, hij, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nlo = fj[loj]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.where(nlo < hij, nlo, loj)))


def test_cuda_wrappers_refuse_cpu_tensors():
    before = dict(probe.launches)
    x = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        probe.add_one(x)
    with pytest.raises(ValueError, match="CUDA"):
        probe.jump_step(x, x, x)
    assert probe.launches == before
    # the dispatcher takes the plain version on CPU tensors only
    assert torch.equal(probe.dispatch(probe.add_one, probe.add_one_plain, x),
                       x + 1)
    assert probe.launches == before


def test_probe_inputs_follow_the_recipe():
    f, lo, hi = kernel_probe.probe_inputs(1 << 10, "cpu")
    for got, want in zip((f, lo, hi), _recipe(1 << 10)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_probe_tool_on_cpu(capsys):
    assert kernel_probe.main(["10", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["platform"] == rec["device"] == "cpu"
    assert rec["log_n"] == 10
    assert rec["trivial_kernel"] == "ok"
    assert rec["jump_kernel_correct"] is True
    assert rec["jump_kernel_ms"] >= 0 and rec["jump_torch_ms"] >= 0


def test_probe_tool_exits_1_on_failure(capsys, monkeypatch):
    assert kernel_probe.main(["4", "--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert "LOG_N" in rec["error"]
    monkeypatch.setattr(probe, "add_one_plain", lambda x: x)
    assert kernel_probe.main(["10", "--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["trivial_kernel"] == "WRONG RESULT"
    assert "jump_kernel_correct" not in rec
    monkeypatch.undo()
    real = probe.dispatch

    def wrong_jump(kernel, plain, *t):
        out = real(kernel, plain, *t)
        return out + 1 if kernel is probe.jump_step else out

    monkeypatch.setattr(probe, "dispatch", wrong_jump)
    assert kernel_probe.main(["10", "--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["trivial_kernel"] == "ok"
    assert rec["jump_kernel_correct"] is False


def _wild(n, seed, off=0, extra=0):
    """The probe's f, and lo drawn below 0 (down to -n - 37, so past the
    wrap too) and at or past the width, as views at storage offset
    ``off`` of longer buffers."""
    rng = np.random.default_rng(seed)
    f = np.minimum(np.arange(n) + rng.integers(1, 64, n), n - 1)
    size = n + extra
    lo = rng.integers(-n - 37, n + 37, size + off)
    hi = lo + rng.integers(-3, 1024, size + off)
    lo_t = torch.from_numpy(lo.astype(np.int32))[off:off + size]
    hi_t = torch.from_numpy(hi.astype(np.int32))[off:off + size]
    return torch.from_numpy(f.astype(np.int32)), lo_t, hi_t


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("log_n", [8, 11])
def test_jump_step_plain_offset_views_and_wild_lo(log_n, off):
    """P2's plain version on views at storage offsets 0-3 (the layouts
    that take the kernel's scalar path) with lo below 0 and past the
    table: equal to the probe's jnp formula (jump_jnp) and to the
    reference's jump_group with one table in interpret mode, which both
    count a negative index from the end and clamp the rest."""
    n = 1 << log_n
    f, lo, hi = _wild(n, seed=log_n + off, off=off, extra=3)
    assert lo.storage_offset() == off
    assert (lo < -n).any() and (lo < 0).any() and (lo >= n).any()
    got = probe.jump_step_plain(f, lo, hi).numpy()
    fj, loj, hij = (jnp.asarray(t.numpy()) for t in (f, lo, hi))
    nlo = fj[loj]
    np.testing.assert_array_equal(got,
                                  np.asarray(jnp.where(nlo < hij, nlo, loj)))
    want = jump_group((fj,), loj, hij, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("log_n", [9, 13])
def test_dispatch_jump_step_takes_plain_on_cpu(log_n, off):
    """The probe tool's dispatcher on CPU views at storage offsets 0-3
    with lo below 0 and past the table: the plain version, equal to the
    probe's jnp formula (jump_jnp), and no launch counted."""
    n = 1 << log_n
    f, lo, hi = _wild(n, seed=100 + log_n + off, off=off, extra=off)
    before = dict(probe.launches)
    got = probe.dispatch(probe.jump_step, probe.jump_step_plain, f, lo, hi)
    assert probe.launches == before
    fj, loj, hij = (jnp.asarray(t.numpy()) for t in (f, lo, hi))
    nlo = fj[loj]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.where(nlo < hij, nlo, loj)))
