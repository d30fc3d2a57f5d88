"""The readers of the program's new timers and counter, the reduction of
the program's spans against hand-made profiler events
(``harness.spans``), and, on the card, K1's bytes as the program counts
them against the harness's recorder, and a tiny traced run of the spans
tool."""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, REPO, tiny_spec
from harness.peaks import k1_bytes
from harness.session import Build, Run
from harness.spans import device_only, read_spans
from harness.spec import Spec
from harness.trace import BUILD_SPAN, reduce_events
from sheep_tpu_torch.obs.trace import CapturedSpan

SPEC = Spec.load(REPO)
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _run(perfs):
    builds = [Build(float(i), float(i + 1), None, p)
              for i, p in enumerate(perfs)]
    return Run(cell=None, graph=SimpleNamespace(records=1000), setup_s=1.0,
               builds=builds)


@pytest.mark.parametrize("name", ["unpack_s", "block_pad_s",
                                  "block_upload_s"])
def test_span_timer_readers_average_and_stay_silent(name):
    run = _run([{name: 0.5}, {name: 0.7}, None])
    assert SPEC.reader(name)(run) == pytest.approx(0.6)
    assert SPEC.reader(name)(_run([{"loop_s": 0.1}])) is None
    assert SPEC.reader(name)(_run([])) is None


def test_k1_gib_reads_the_program_s_bytes():
    run = _run([{"k1_bytes": 3 * 2**30}, {"k1_bytes": 5 * 2**30}])
    assert SPEC.reader("k1_gib")(run) == pytest.approx(4.0)
    # a parent without the counter, or no descent on the card: nothing
    assert SPEC.reader("k1_gib")(_run([{"loop_s": 0.1}])) is None
    assert SPEC.reader("k1_gib")(_run([{"k1_bytes": 0}])) is None


def _ev(name, start, end, device=CUDA, id=0, parent=None, annotation=False,
        thread=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           cpu_parent=parent, is_user_annotation=annotation,
                           device_resource_id=thread,
                           time_range=SimpleNamespace(start=start, end=end))


THREAD_3 = (7 << 32) + (1 << 31) + 3  # an ident wider than 32 bits


def _window():
    """One build of 1000 us; the program's ranges (main thread 1) and
    the device work each one launched.

    main:     build.prep 0-100, build.loop 100-400, handoff.tail 400-800
              (handoff.sort 400-450 inside it)
    thread 2: build.prefetch 10-900;  thread 3: handoff.slice 500-600
    device:   30-80 from an op in build.prep, 150-350 from build.loop
              itself (a kernel bound without an op), 420-440 from
              handoff.sort, 560-590 from thread 3 (handoff.slice, though
              the profiler nests its call in handoff.tail), 960-970 from
              an op in no span."""
    prep = _ev("build.prep", 0, 100, CPU)
    loop = _ev("build.loop", 100, 400, CPU)
    tail = _ev("handoff.tail", 400, 800, CPU)
    sort = _ev("handoff.sort", 400, 450, CPU, parent=tail)
    gather = _ev("aten::gather", 15, 40, CPU, parent=prep)
    copy = _ev("aten::copy_", 955, 965, CPU)
    # the profiler names the first thread by its native id (101) and
    # nests another thread's calls under the first thread's ranges by
    # time, naming that thread by the low 32 bits of its ident, signed
    calls = [_ev("cudaLaunchKernel", 20, 25, CPU, 11, gather, thread=101),
             _ev("cudaLaunchKernel", 140, 145, CPU, 12, loop, thread=101),
             _ev("cudaLaunchKernel", 410, 415, CPU, 13, sort, thread=101),
             _ev("cudaMemcpyAsync", 550, 555, CPU, 14, tail,
                 thread=(THREAD_3 & 0xFFFFFFFF) - (1 << 32)),
             _ev("cudaMemcpyAsync", 958, 960, CPU, 15, copy, thread=101)]
    work = [_ev("gather_kernel", 30, 80, id=11),
            _ev("fused_jump_kernel", 150, 350, id=12),
            _ev("sort_kernel", 420, 440, id=13),
            _ev("Memcpy DtoH", 560, 590, id=14),
            _ev("Memcpy DtoD", 960, 970, id=15)]
    notes = [_ev(BUILD_SPAN, 0, 1000, annotation=True),
             _ev("build.prep", 30, 80, annotation=True),
             _ev("build.loop", 150, 350, annotation=True),
             _ev("handoff.tail", 420, 700)]  # no flag: found by name
    events = [_ev(BUILD_SPAN, 0, 1000, CPU), prep, loop, tail, sort,
              gather, copy, *calls, *work]
    t0 = 5.0  # the build's perf_counter start

    def sp(name, id, par, tid, s, e):
        return CapturedSpan(name, id, par, tid, tid + 100, t0 + s / 1e6,
                            t0 + e / 1e6, {})

    spans = [sp("build.prep", 1, None, 1, 0, 100),
             sp("build.loop", 2, None, 1, 100, 400),
             sp("handoff.tail", 3, None, 1, 400, 800),
             sp("handoff.sort", 4, 3, 1, 400, 450),
             sp("build.prefetch", 5, None, 2, 10, 900),
             sp("handoff.slice", 6, None, THREAD_3, 500, 600)]
    return events, notes, spans, [t0]


def test_reduce_events_reads_the_same_with_program_ranges_dropped():
    events, notes, spans, starts = _window()
    names = {sp.name for sp in spans}
    plain = reduce_events(events, starts)
    dropped = reduce_events(device_only(events + notes, names), starts)
    assert dropped.busy_s == pytest.approx(plain.busy_s)
    assert dropped.window_s == pytest.approx(plain.window_s)
    assert dropped.device_ops == pytest.approx(plain.device_ops)
    assert dropped.gaps == plain.gaps
    # kept, the ranges would read as device work
    assert reduce_events(events + notes, starts).busy_s > plain.busy_s


def test_read_spans_layers_idle_and_gaps():
    events, notes, spans, starts = _window()
    rd = read_spans(events + notes, spans, starts, main_tid=1,
                    main_native=101)
    assert rd.builds == 1
    assert rd.busy_s == pytest.approx(310e-6)
    assert rd.layer_device_s == pytest.approx({
        "prep_device_s": 50e-6, "loop_device_s": 200e-6,
        "handoff_device_s": 50e-6})
    assert rd.span_device_s == pytest.approx({
        "build.prep": 50e-6, "build.loop": 200e-6, "handoff.sort": 20e-6,
        "handoff.tail": 20e-6, "handoff.slice": 30e-6})
    assert rd.unattributed_device_s == pytest.approx(10e-6)
    assert rd.unattributed_why == pytest.approx(
        {"launched on the profiling thread in no span": 10e-6})
    assert rd.profiled == {"build.prep", "build.loop", "handoff.tail",
                           "handoff.sort"}
    assert rd.not_profiled == {"build.prefetch", "handoff.slice"}
    # idle 690 us; none of the layer spans open in 900-960 and 970-1000
    assert rd.idle_s == pytest.approx(690e-6)
    assert rd.idle_unattributed_s == pytest.approx(90e-6)
    assert rd.idle_unattributed_pct() == pytest.approx(100 * 90 / 690)
    assert [x for piece in rd.unexplained for x in piece] == \
        pytest.approx([900e-6, 960e-6, 970e-6, 1000e-6])
    assert rd.span_host_s["build.loop"] == pytest.approx(300e-6)
    assert [round(s * 1e6) for s, _ in rd.gaps] == [370, 120, 70, 70, 30,
                                                    30]
    # each thread's innermost span over the gap: of those covering at
    # least half as much as the widest, the shortest
    tail = "build.prefetch + handoff.slice + handoff.tail"
    loop = "build.loop + build.prefetch"
    assert [label for label, _ in rd.top_gaps()] == [
        tail, tail, loop, loop, "build.prefetch + build.prep",
        "no layer span"]


def test_read_spans_without_builds_reads_nothing():
    rd = read_spans([], [], [], main_tid=1, main_native=1)
    assert rd.idle_unattributed_pct() is None and rd.per_build(1.0) is None


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_k1_span_bytes_equal_the_recorder_s(cuda_device):
    """One small hybrid build on the card under the harness's K1
    recorder and a capture: the ``forest.k1`` spans' bytes, the
    program's counter and ``harness.peaks.k1_bytes`` over the recorded
    descents are one number."""
    from harness.trace import K1Recorder
    from sheep_tpu_torch.obs import trace as obs
    from sheep_tpu_torch.ops.build import build_graph_hybrid
    from sheep_tpu_torch.utils import rmat_edges

    tail, head = rmat_edges(18, 1 << 21, seed=5)
    build_graph_hybrid(tail, head, 1 << 18, device=cuda_device)  # warm
    perf = {}
    with K1Recorder() as rec, obs.capture() as cap:
        build_graph_hybrid(tail, head, 1 << 18, perf=perf,
                           device=cuda_device)
    spans = cap.named("forest.k1")
    assert rec.descents and len(spans) == len(rec.descents)
    want = sum(k1_bytes(*d) for d in rec.descents)
    assert sum(sp.attrs["bytes"] for sp in spans) == want
    assert perf["k1_bytes"] == want
    assert [(sp.attrs["links"], sp.attrs["levels"], sp.attrs["width"])
            for sp in spans] == rec.descents


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lj.build", "lj.stream"])
def test_spans_tool_reads_every_layer_on_the_card(tmp_path, cuda_device,
                                                  cell):
    sys.path.insert(0, os.path.join(BENCH, "tools"))
    try:
        import spans as tool
    finally:
        sys.path.pop(0)
    spec = tiny_spec(tmp_path, log_n=18, records=1 << 21, block=1 << 19)
    got = tool.traced(spec, cell, 3, 1.0, cuda_device)
    assert got["correct"] is True and got["builds"] >= 1
    sp = got["spans"]
    assert sp["loop_device_s"] > 0 and sp["handoff_device_s"] > 0
    assert sp["idle_unattributed_pct"] is not None
    assert sp["busy_s"] > 0 and sp["span_device_s"]["build.loop"] > 0
    assert "build.loop" in sp["profiled"]
    assert got["metrics"]["k1_gib"] > 0
    assert 0 < got["metrics"]["device_idle_pct"] < 100
