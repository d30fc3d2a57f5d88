"""The build path's layer spans (sheep_tpu_torch/obs/trace.py's capture
and profiler bridge; the spans of ops/build.py, ops/stream.py and
ops/forest.py): which spans a small hybrid build and a small out-of-core
build emit, on which threads and under which parents; that each ``perf``
timer is its span's duration; that K1's span is absent on the CPU; that
with tracing off no span exists, none is captured and none makes a CUDA
call; that under a CPU ``torch.profiler`` the spans are
``record_function`` ranges; and that ``cli.trace`` rolls them up.

The hybrid runs with the card's windowed tail on CPU tensors
(``SHEEP_STREAM_DEVICE_WINDOWS=1``, three windows of 512-link slices)
and the host prefetch thread (``SHEEP_STREAM_HOST_SEQ=0``)."""

import contextlib
import io
import json
import threading

import numpy as np
import pytest
import torch

from sheep_tpu_torch.cli import trace as trace_cli
from sheep_tpu_torch.core.sequence import degree_sequence
from sheep_tpu_torch.obs import trace as obs
from sheep_tpu_torch.ops import forest
from sheep_tpu_torch.ops.build import build_graph_hybrid
from sheep_tpu_torch.ops.stream import build_graph_streaming_hosted
from sheep_tpu_torch.utils import rmat_edges

LOG_N = 12
N = 1 << LOG_N
BLOCK = 6 << 10  # 32,768 records: five full blocks and one of 2,048

HYBRID_MAIN = {"build.prep", "build.loop", "handoff.tail", "handoff.sort",
               "handoff.pst_wait", "handoff.unpack", "handoff.fold"}
STREAM_MAIN = {"stream.pad", "stream.upload", "stream.links", "stream.loop",
               "build.loop", "handoff.tail", "handoff.sort",
               "handoff.pst_wait", "handoff.unpack", "handoff.fold"}
IN_TAIL = {"handoff.sort", "handoff.pst_wait", "handoff.unpack",
           "handoff.fold"}


@pytest.fixture(autouse=True)
def span_env(monkeypatch):
    for k, v in (("SHEEP_STREAM_HANDOFF", "1"),
                 ("SHEEP_STREAM_DEVICE_WINDOWS", "1"),
                 ("SHEEP_STREAM_HOST_SEQ", "0"),
                 ("SHEEP_HANDOFF_WINDOWS", "3"),
                 ("SHEEP_OVERLAP_SLICE", "512"),
                 ("SHEEP_PACK_HANDOFF", "1")):
        monkeypatch.setenv(k, v)
    for k in ("SHEEP_TRACE", "SHEEP_TRACE_SAMPLE", "SHEEP_HANDOFF_FACTOR"):
        monkeypatch.delenv(k, raising=False)
    obs.close_recorder()
    yield monkeypatch
    obs.close_recorder()


@pytest.fixture(scope="module")
def graph():
    tail, head = rmat_edges(LOG_N, 8 * N, seed=3)
    seq = degree_sequence(tail, head, N)
    pos = np.full(N, 0xFFFFFFFF, np.uint32)
    pos[seq] = np.arange(len(seq), dtype=np.uint32)
    return tail, head, seq, pos


def hybrid(graph, perf=None):
    tail, head = graph[:2]
    seq, f = build_graph_hybrid(tail, head, N, handoff_factor=2, perf=perf,
                                device="cpu")
    return seq, f.parent, f.pst_weight


def stream(graph, perf=None):
    tail, head, seq, pos = graph

    def blocks():
        for s in range(0, len(tail), BLOCK):
            yield tail[s:s + BLOCK], head[s:s + BLOCK]

    f, _ = build_graph_streaming_hosted(blocks(), len(seq), pos, BLOCK,
                                        device="cpu", perf=perf)
    return f.parent, f.pst_weight


BUILDS = {"hybrid": hybrid, "stream": stream}


def captured(build, graph):
    perf = {}
    with obs.capture() as cap:
        out = build(graph, perf)
    return out, perf, cap


def _parents(cap):
    by_id = {sp.id: sp for sp in cap.spans}
    return {sp.id: by_id[sp.par].name if sp.par is not None else None
            for sp in cap.spans}


def test_hybrid_build_emits_the_layer_spans(graph):
    main = threading.get_ident()
    out, _, cap = captured(hybrid, graph)
    for got, want in zip(out, hybrid(graph)):
        np.testing.assert_array_equal(got, want)
    par = _parents(cap)
    on_main = {sp.name for sp in cap.spans if sp.tid == main}
    assert HYBRID_MAIN <= on_main
    assert not on_main & {"build.prefetch", "build.prefetch.seq",
                          "build.prefetch.pst", "handoff.slice"}
    for sp in cap.spans:
        if sp.name in {"build.prep", "build.loop", "handoff.tail",
                       "build.prefetch", "handoff.slice"}:
            assert par[sp.id] is None, sp
        elif sp.name in IN_TAIL:
            assert par[sp.id] == "handoff.tail", sp
        elif sp.name in {"build.prefetch.seq", "build.prefetch.pst"}:
            assert par[sp.id] == "build.prefetch", sp
    pre = cap.named("build.prefetch")
    assert len(pre) == 1 and pre[0].tid != main
    assert {sp.tid for sp in cap.named("build.prefetch.seq")} == {pre[0].tid}
    slices = cap.named("handoff.slice")
    assert slices and all(sp.tid != main for sp in slices)
    assert all(sp.attrs["bytes"] == 512 * 6 for sp in slices)
    assert len(cap.named("handoff.fold")) == 3
    assert len(cap.named("handoff.sort")) == 2  # the hi-sort, the pack
    tail = cap.named("handoff.tail")[0]
    assert tail.attrs["windows"] == 3
    assert tail.attrs["links"] == sum(sp.attrs["links"]
                                      for sp in cap.named("handoff.fold"))
    prep = cap.named("build.prep")[0]
    assert prep.attrs == {"records": len(graph[0]), "n": N}
    loop = cap.named("build.loop")[0]
    assert loop.attrs["rounds"] > 0
    assert loop.attrs["links"] >= loop.attrs["live"]
    for sp in cap.named("handoff.fold"):
        kids = [k for k in cap.spans if k.par == sp.id]
        assert [k.name for k in kids] == ["native.links_fold.block"]


def test_stream_build_emits_the_layer_spans(graph):
    main = threading.get_ident()
    out, _, cap = captured(stream, graph)
    for got, want in zip(out, stream(graph)):
        np.testing.assert_array_equal(got, want)
    par = _parents(cap)
    assert STREAM_MAIN <= {sp.name for sp in cap.spans if sp.tid == main}
    blocks = -(-len(graph[0]) // BLOCK)
    for name in ("stream.pad", "stream.upload", "stream.links",
                 "stream.loop"):
        got = cap.named(name)
        assert len(got) == blocks and all(par[sp.id] is None for sp in got)
    records = [min(BLOCK, len(graph[0]) - s)
               for s in range(0, len(graph[0]), BLOCK)]
    assert [sp.attrs["records"] for sp in cap.named("stream.pad")] == records
    # the exact records cross as int32 pairs; the card fills the rest
    assert [sp.attrs["records"] for sp in cap.named("stream.upload")] == \
        records
    assert [sp.attrs["bytes"] for sp in cap.named("stream.upload")] == \
        [8 * r for r in records]
    assert [sp.attrs["pad"] for sp in cap.named("stream.pad")] == \
        [BLOCK - r for r in records]
    assert all(sp.attrs["links"] >= sp.attrs["live"]
               for sp in cap.named("stream.loop"))
    for sp in cap.spans:
        if sp.name in IN_TAIL:
            assert par[sp.id] == "handoff.tail", sp
    assert all(sp.tid != main for sp in cap.named("handoff.slice"))
    assert not cap.named("build.prefetch")  # the sequence is given


def _round_sum(spans):
    return round(sum(sp.dur for sp in spans), 4)


def test_hybrid_perf_keys_are_their_spans_durations(graph):
    _, perf, cap = captured(hybrid, graph)
    one = {"prefetch_s": "build.prefetch",
           "prefetch_seq_s": "build.prefetch.seq",
           "prefetch_pst_s": "build.prefetch.pst", "loop_s": "build.loop",
           "fetch_tail_s": "handoff.tail", "pst_wait_s": "handoff.pst_wait"}
    for key, name in one.items():
        [sp] = cap.named(name)
        assert perf[key] == round(sp.dur, 4), key
    folds = cap.named("handoff.fold")
    assert perf["fold_s"] == _round_sum(folds)
    assert perf["window_fold_s"] == [round(sp.dur, 4) for sp in folds]
    assert perf["unpack_s"] == _round_sum(cap.named("handoff.unpack"))
    assert "window_fetch_phases" not in perf


def test_stream_perf_keys_are_their_spans_durations(graph):
    _, perf, cap = captured(stream, graph)
    for key, name in (("block_pad_s", "stream.pad"),
                      ("block_upload_s", "stream.upload"),
                      ("block_loop_s", "stream.loop"),
                      ("fold_s", "handoff.fold"),
                      ("unpack_s", "handoff.unpack")):
        assert perf[key] == _round_sum(cap.named(name)), key
    assert perf["block_upload_bytes"] == sum(
        sp.attrs["bytes"] for sp in cap.named("stream.upload")) == \
        8 * len(graph[0])
    for key, name in (("loop_s", "build.loop"),
                      ("fetch_tail_s", "handoff.tail"),
                      ("pst_wait_s", "handoff.pst_wait")):
        [sp] = cap.named(name)
        assert perf[key] == round(sp.dur, 4), key


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_k1_span_is_absent_on_the_cpu(graph, build):
    before = forest.k1_bytes
    _, perf, cap = captured(BUILDS[build], graph)
    assert not cap.named("forest.k1")
    assert perf["k1_bytes"] == 0 and forest.k1_bytes == before


def test_tracing_off_spans_are_the_noop_and_nothing_is_captured(graph):
    assert obs.span("build.loop") is obs.NOOP_SPAN
    assert obs.span("a", x=1) is obs.span("b")
    with obs.capture() as cap:
        assert obs.span("inside") is not obs.NOOP_SPAN
    assert obs.span("after") is obs.NOOP_SPAN
    hybrid(graph, {})
    assert cap.spans == []


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_tracing_off_build_makes_no_cuda_call_for_a_span(graph, build,
                                                         monkeypatch):
    """No span object, no profiler range, no CUDA event, stream or
    synchronisation: every span the build asks for is the shared no-op."""
    asked, made = [], []
    span = obs.span

    def watched(name, **attrs):
        got = span(name, **attrs)
        asked.append((name, got))
        return got

    def refused(what):
        def call(*a, **k):
            made.append(what)
            raise AssertionError(f"{what} called with tracing off")
        return call

    monkeypatch.setattr(obs, "span", watched)
    monkeypatch.setattr(obs, "_profiler_range", refused("record_function"))
    monkeypatch.setattr(obs._Span, "__init__", refused("_Span"))
    for name in ("synchronize", "Event", "Stream", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refused(f"torch.cuda.{name}"))
    monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                        refused("_profiler_enabled"))
    BUILDS[build](graph, {})
    assert made == []
    names = {name for name, _ in asked}
    assert {"build.loop", "handoff.tail", "handoff.fold"} <= names
    assert all(got is obs.NOOP_SPAN for _, got in asked)


def test_spans_are_record_function_ranges_under_a_cpu_profiler(graph):
    from torch.profiler import ProfilerActivity, profile

    main = threading.get_ident()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.capture() as cap:
            hybrid(graph)
        hybrid(graph)  # spans off: no ranges
    events = prof.events()
    on_main = [sp for sp in cap.spans if sp.tid == main]
    assert HYBRID_MAIN <= {sp.name for sp in on_main}
    for name in HYBRID_MAIN:
        ranges = [ev for ev in events if ev.name == name]
        assert len(ranges) == len([sp for sp in on_main if sp.name == name])
    # outside the profiler a span opens no range
    with obs.capture() as cap:
        with obs.span("quiet") as sp:
            assert sp.prof is None


def test_cli_trace_rolls_up_the_build_spans(graph, tmp_path, span_env):
    path = str(tmp_path / "build.trace")
    span_env.setenv("SHEEP_TRACE", path)
    hybrid(graph)
    stream(graph)
    obs.close_recorder()
    span_env.delenv("SHEEP_TRACE")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert trace_cli.main(["--json", path]) == 0
    phases = json.loads(out.getvalue())["phases"]
    for name in HYBRID_MAIN | STREAM_MAIN | {
            "build.prefetch", "build.prefetch.seq", "build.prefetch.pst",
            "handoff.slice"}:
        assert phases[name]["count"] >= 1, name
    assert phases["build.loop"]["count"] == 2
    assert phases["stream.loop"]["count"] == -(-len(graph[0]) // BLOCK)


def test_capture_beside_sheep_trace_keeps_the_file_s_spans(tmp_path,
                                                           span_env):
    path = str(tmp_path / "both.trace")
    span_env.setenv("SHEEP_TRACE", path)
    with obs.capture() as outer:
        with obs.span("a", k=1):
            with obs.capture() as inner:
                with obs.span("b"):
                    pass
    obs.close_recorder()
    recs = [r for r in obs.read_trace(path, "strict")[0] if r["k"] == "span"]
    assert [(r["name"], r["id"], r["par"], r["a"]) for r in recs] == \
        [(sp.name, sp.id, sp.par, sp.attrs) for sp in outer.spans]
    assert [sp.name for sp in inner.spans] == ["b"]
    assert [sp.name for sp in outer.spans] == ["b", "a"]


def test_capture_keeps_every_thread_and_timed_reads_the_span():
    out = []
    with obs.capture() as cap:
        th = threading.Thread(target=lambda: obs.span("worker").__enter__()
                              .__exit__(None, None, None))
        th.start()
        th.join()
        with obs.timed("phase", out, x=2) as sp:
            sp.annotate(y=3)
        with pytest.raises(ValueError):
            with obs.timed("boom", out):
                raise ValueError
    worker, phase, boom = cap.spans
    assert worker.name == "worker" and worker.tid != threading.get_ident()
    assert phase.attrs == {"x": 2, "y": 3} and out == [phase.dur]
    assert boom.name == "boom" and len(out) == 1
