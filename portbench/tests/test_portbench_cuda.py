"""On the card (marker ``cuda``; skips without one): a small run of each
cell through the card's path, traced, with the device metrics read."""

from __future__ import annotations

import time

import pytest

from conftest import tiny_spec
from harness import session

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["lj.build", "lj.stream"])
def test_small_traced_run_on_the_card(tmp_path, cuda_device, cell):
    spec = tiny_spec(tmp_path, log_n=18, records=1 << 21, block=1 << 19)
    result, _ = session.run_cell(spec, cell, 3, 1.0, True, cuda_device,
                                 time.perf_counter())
    assert result["correct"] is True
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 < result["metrics"]["device_idle_pct"]["value"] < 100
    assert 0 < result["metrics"]["k1_roofline_pct"]["value"] <= 105
    assert result["breakdown"]["device_ops"]
