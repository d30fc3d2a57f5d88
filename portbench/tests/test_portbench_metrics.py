"""The metric arithmetic: K1's least work, the readers, and the trace
reduction on hand-made events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from conftest import REPO
from harness.peaks import HBM_BYTES_PER_S, k1_bound_s, k1_bytes
from harness.session import Build, Run
from harness.spec import Spec
from harness.trace import BUILD_SPAN, HostSampler, reduce_events

SPEC = Spec.load(REPO)
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def test_k1_bound_hand_worked():
    """n = 2^23 (tables of n + 1 entries), E = 2^26, L = 4: 12 E + 16 (n+1)
    bytes over 3.35 TB/s = 0.2805 ms (chip_smoke.k1_bound_ms)."""
    n, e, levels = 1 << 23, 1 << 26, 4
    assert k1_bytes(e, levels, n + 1) == 12 * e + 4 * levels * (n + 1)
    assert HBM_BYTES_PER_S == 3.35e12
    assert round(k1_bound_s(e, levels, n + 1) * 1e3, 4) == 0.2805


def _ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce_events_busy_gaps_and_ops():
    """Two builds of 100 us each; device work 10-30 and 20-40 (overlap)
    and 60-70 in the first, 150-200 in the second.  The span's own
    annotation on the device's rows is not work."""
    events = [_ev(BUILD_SPAN, 0, 100, CPU), _ev(BUILD_SPAN, 0, 100, CUDA),
              _ev(BUILD_SPAN, 120, 220, CPU),
              _ev("k", 10, 30), _ev("copy", 20, 40), _ev("k", 60, 70),
              _ev("k", 150, 200), _ev("aten::add", 40, 60, CPU),
              _ev("before", -50, -10)]
    tl = reduce_events(events)
    assert tl.window_s == pytest.approx(200e-6)
    assert tl.busy_s == pytest.approx(90e-6)
    assert tl.device_ops == pytest.approx({"k": 80e-6, "copy": 20e-6,
                                           "before": 40e-6})
    gaps = sorted(round(s * 1e6) for s, _ in tl.gaps)
    assert gaps == [10, 20, 20, 30, 30]
    labels = [label for _, label in tl.gaps]
    assert "not sampled | copy -> k" in labels
    assert "not sampled | k -> build end" in labels
    assert tl.top_ops(1) == [["k", pytest.approx(80e-6)]]


def test_gap_labelled_by_host_samples():
    sampler = HostSampler()
    sampler.samples = [(1.000010, "ops/build.py:_host_seq_pst"),
                       (1.000015, "ops/build.py:_host_seq_pst"),
                       (1.000018, "ops/forest.py:reduce_links_hosted")]
    events = [_ev(BUILD_SPAN, 0, 100, CPU), _ev("k", 0, 5),
              _ev("k", 90, 100)]
    tl = reduce_events(events, build_starts=[1.0], sampler=sampler)
    assert tl.gaps[0][1].startswith("ops/build.py:_host_seq_pst | k -> k")


def _run(builds, timeline=None, k1=None, setup=3.0, records=1000):
    run = Run(cell=None, graph=SimpleNamespace(records=records),
              setup_s=setup, builds=builds, timeline=timeline, k1=k1)
    return run


def test_end_to_end_readers():
    builds = [Build(10.0, 12.0, 2**30, None), Build(12.0, 14.5, 3 * 2**30,
                                                      None)]
    run = _run(builds)
    assert SPEC.reader("records_per_s")(run) == pytest.approx(2000 / 4.5)
    assert SPEC.reader("peak_device_gib")(run) == pytest.approx(3.0)
    assert SPEC.reader("setup_s")(run) == 3.0
    assert SPEC.reader("records_per_s")(_run([])) is None


def test_perf_readers_average_and_stay_silent():
    builds = [Build(0, 1, None, {"prefetch_s": 4.0, "fold_s": 0.5}),
              Build(1, 2, None, {"prefetch_s": 6.0, "fold_s": 0.7})]
    run = _run(builds)
    assert SPEC.reader("prefetch_s")(run) == pytest.approx(5.0)
    assert SPEC.reader("fold_s")(run) == pytest.approx(0.6)
    assert SPEC.reader("block_loop_s")(run) is None
    assert SPEC.reader("loop_s")(_run([Build(0, 1, None, None)])) is None


def test_block_intake_is_the_stream_build_less_its_timed_parts():
    """2.0 s and 2.4 s builds whose block loop, final loop and tail take
    0.4 + 0.1 + 0.5 and 0.4 + 0.1 + 0.7 s leave 1.0 and 1.2 s."""
    timed = [{"block_loop_s": 0.4, "loop_s": 0.1, "fetch_tail_s": 0.5},
             {"block_loop_s": 0.4, "loop_s": 0.1, "fetch_tail_s": 0.7}]
    run = _run([Build(0.0, 2.0, None, timed[0]),
                Build(2.0, 4.4, None, timed[1])])
    assert SPEC.reader("block_intake_s")(run) == pytest.approx(1.1)
    assert SPEC.reader("fetch_tail_s")(run) == pytest.approx(0.6)
    # an in-memory build has no block loop: nothing is written
    hybrid = _run([Build(0, 7, None, {"loop_s": 0.1, "fetch_tail_s": 6.0})])
    assert SPEC.reader("block_intake_s")(hybrid) is None


def test_device_readers():
    tl = SimpleNamespace(window_s=10.0, busy_s=0.5,
                         device_ops={"(anonymous namespace)::fused_jump_"
                                     "kernel(int const*, ...)": 0.002,
                                     "other": 0.3})
    k1 = SimpleNamespace(descents=[(1 << 26, 4, (1 << 23) + 1)])
    run = _run([], timeline=tl, k1=k1)
    assert SPEC.reader("device_idle_pct")(run) == pytest.approx(95.0)
    got = SPEC.reader("k1_roofline_pct")(run)
    assert got == pytest.approx(100 * k1_bound_s(1 << 26, 4, (1 << 23) + 1)
                                / 0.002)
    # no device work, no descents: nothing is written, never a 0
    idle = SimpleNamespace(window_s=10.0, busy_s=0.0, device_ops={})
    assert SPEC.reader("device_idle_pct")(_run([], timeline=idle)) is None
    assert SPEC.reader("k1_roofline_pct")(_run([], timeline=idle)) is None
    none_run = _run([], timeline=idle,
                    k1=SimpleNamespace(descents=[]))
    assert SPEC.reader("k1_roofline_pct")(none_run) is None
