"""The port's build entry points (sheep_tpu_torch/ops/build.py) equal
sheep_tpu's ops/build.py (JAX on the CPU) and the host oracle exactly.

The hybrid's cases run on both handoff arms (the ``arm`` fixture), each
package under the same knobs: the streamed windowed handoff, the default,
and the serial arm (SHEEP_STREAM_HANDOFF=0 SHEEP_OVERLAP_HANDOFF=0)."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_multigraph

import sheep_tpu.ops.build as RB
from sheep_tpu.core import build_forest, compute_facts, degree_sequence

import sheep_tpu_torch.ops.build as PB
from sheep_tpu_torch import core as PC
from sheep_tpu_torch.convert import edges_to_device
from sheep_tpu_torch.io import load_edges
from sheep_tpu_torch.utils import rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")


@pytest.fixture(params=["serial", "stream"])
def arm(request, monkeypatch):
    """The handoff arm, set for both packages: "serial" is one fetch and
    one fold, "stream" the streamed windowed handoff (the default)."""
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF",
                       "0" if request.param == "serial" else "1")
    monkeypatch.setenv("SHEEP_OVERLAP_HANDOFF", "0")
    for k in ("SHEEP_HANDOFF_WINDOWS", "SHEEP_STREAM_DEVICE_WINDOWS",
              "SHEEP_STREAM_HOST_SEQ"):
        monkeypatch.delenv(k, raising=False)
    return request.param


def _graph(seed, n_max=200, e_max=1200):
    rng = np.random.default_rng(seed)
    return random_multigraph(rng, n_max, e_max)


def _same(got, want):
    gseq, gf = got
    wseq, wf = want
    assert gseq.dtype == np.uint32 and gf.parent.dtype == np.uint32
    np.testing.assert_array_equal(gseq, wseq)
    np.testing.assert_array_equal(gf.parent, wf.parent)
    np.testing.assert_array_equal(gf.pst_weight, wf.pst_weight)


@pytest.mark.parametrize("with_pst", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_prepare_links(seed, with_pst):
    tail, head = _graph(7000 + seed)
    n = int(max(tail.max(), head.max())) + 1
    t, h = edges_to_device(tail, head, "cpu")
    got = PB.prepare_links(t, h, n, with_pst=with_pst)
    want = RB.prepare_links(jnp.asarray(tail), jnp.asarray(head), n,
                            with_pst=with_pst)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_host_seq_pst():
    tail, head = _graph(961, 300, 2000)  # includes self-loops
    n = int(max(tail.max(), head.max())) + 1
    full = degree_sequence(tail, head)
    for seq in (None, full[: len(full) * 2 // 3]):
        got = PB._host_seq_pst(tail, head, n, seq=seq)
        want = RB._host_seq_pst(tail, head, n, seq=seq)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_build_graph_device(seed):
    tail, head = _graph(7100 + seed)
    got = PB.build_graph_device(tail, head, device="cpu")
    _same(got, RB.build_graph_device(tail, head))
    seq = degree_sequence(tail, head)
    _same(got, (seq, build_forest(tail, head, seq)))


def test_build_graph_device_rmat_and_empty():
    tail, head = rmat_edges(12, 4 << 12, seed=3)
    _same(PB.build_graph_device(tail, head, device="cpu"),
          RB.build_graph_device(tail, head))
    seq, forest = PB.build_graph_device(np.empty(0, np.uint32),
                                        np.empty(0, np.uint32), device="cpu")
    assert len(seq) == 0 and forest.n == 0


@pytest.mark.parametrize("host_edges", [False, True])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("factor", ["1", "3", "8"])
def test_build_graph_hybrid_matches_reference(arm, monkeypatch,
                                              factor, given, host_edges):
    monkeypatch.setenv("SHEEP_HANDOFF_FACTOR", factor)
    tail, head = _graph(950 + int(factor))
    full = degree_sequence(tail, head)
    # a given SUBSET order exercises the absent-vid pst contract
    seq = full[: max(2, len(full) * 2 // 3)] if given else None
    he = (tail, head) if host_edges else None
    got = PB.build_graph_hybrid(tail, head, host_edges=he, seq=seq,
                                device="cpu")
    want = RB.build_graph_hybrid(tail, head, host_edges=he, seq=seq)
    _same(got, want)
    mv = int(max(tail.max(), head.max()))
    _same(got, (full if seq is None else seq,
                build_forest(tail, head, full if seq is None else seq,
                             max_vid=mv)))


@pytest.mark.parametrize("packed", ["0", "1"])
@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_build_graph_hybrid_knobs(arm, monkeypatch, packed,
                                  pipeline):
    monkeypatch.setenv("SHEEP_PACK_HANDOFF", packed)
    monkeypatch.setenv("SHEEP_PIPELINE_CHUNKS", pipeline)
    if arm == "stream":
        # packing belongs to the card's window queue, forced here
        monkeypatch.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
    tail, head = rmat_edges(13, 6 << 13, seed=11)
    perf = {}
    got = PB.build_graph_hybrid(tail, head, handoff_factor=2, perf=perf,
                                device="cpu")
    want = RB.build_graph_hybrid(tail, head, handoff_factor=2)
    _same(got, want)
    assert perf["packed_handoff"] == (packed == "1")
    assert perf["rounds"] > 0 and perf["handoff_links"] <= 2 * 8192
    keys = ("loop_s", "fetch_tail_s", "fold_s", "pst_wait_s", "live",
            "fetch_windows")
    if arm == "serial":
        assert perf["fetch_windows"] == 0 and "prefetch_s" in perf
    else:
        # the CPU's streamed prep takes the host sequence: no prefetch
        assert perf["stream_mode"] == "windowed" and "prefetch_s" not in perf
        keys += ("window_fetch_s", "window_fold_s", "overlap_s",
                 "overlap_frac")
    for key in keys:
        assert key in perf


def test_build_graph_hybrid_prefetch_failure_lazy_pst(arm, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("prefetch failure injected by test")

    monkeypatch.setattr(PB, "_host_seq_pst", boom)
    tail, head = _graph(962)
    full = degree_sequence(tail, head)
    for seq in (None, full[: len(full) * 2 // 3]):
        for factor in (2, 1000):
            got = PB.build_graph_hybrid(tail, head, handoff_factor=factor,
                                        host_edges=(tail, head), seq=seq,
                                        device="cpu")
            want = RB.build_graph_hybrid(tail, head, handoff_factor=factor,
                                         host_edges=(tail, head), seq=seq)
            _same(got, want)


def test_build_graph_hybrid_tensor_inputs(arm):
    tail, head = _graph(960)
    n = int(max(tail.max(), head.max())) + 1
    t, h = edges_to_device(tail, head, "cpu")
    got = PB.build_graph_hybrid(t, h, n, handoff_factor=1000, device="cpu")
    _same(got, RB.build_graph_hybrid(jnp.asarray(tail), jnp.asarray(head), n,
                                     handoff_factor=1000))


def test_handoff_pieces(monkeypatch):
    from sheep_tpu.native import build_forest_links as ref_fold

    tail, head = _graph(964, 300, 2000)
    n = int(max(tail.max(), head.max())) + 1
    t, h = edges_to_device(tail, head, "cpu")
    _, _, _, lo, hi, pst = PB.prepare_links(t, h, n)
    from sheep_tpu_torch.ops.forest import reduce_links_hosted
    rlo, rhi, live, _, _ = reduce_links_hosted(lo, hi, n, stop_live=n)
    for pack in ("0", "1"):
        monkeypatch.setenv("SHEEP_PACK_HANDOFF", pack)
        lo_h, hi_h, packed = PB.fetch_links_host(rlo, rhi, live, n)
        rlo_h, rhi_h, rpacked = RB.fetch_links_host(
            jnp.asarray(rlo.numpy()), jnp.asarray(rhi.numpy()), live, n)
        assert packed == rpacked == (pack == "1")
        np.testing.assert_array_equal(lo_h, rlo_h)
        np.testing.assert_array_equal(hi_h, rhi_h)
        pst_np = pst.numpy().view(np.uint32)
        got = PB.finish_native_host(lo_h, hi_h, n, lambda: pst_np)
        want = ref_fold(lo_h.astype(np.uint32), hi_h.astype(np.uint32), n,
                        pst_np)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        got2 = PB.handoff_finish_native(rlo, rhi, live, n, pst_np)
        np.testing.assert_array_equal(got2[0], want[0])


def test_device_gates(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("SHEEP_HANDOFF_FACTOR", raising=False)
    monkeypatch.delenv("SHEEP_PACK_HANDOFF", raising=False)
    monkeypatch.delenv("SHEEP_PIPELINE_CHUNKS", raising=False)
    # the reference's cpu defaults on the CPU, its accelerator ones on CUDA
    assert PB.default_handoff_factor(cpu) == RB.default_handoff_factor() == 8
    assert PB.default_handoff_factor(cuda) == 3
    assert PB.pack_handoff(1000, cpu) is RB.pack_handoff(1000) is False
    assert PB.pack_handoff(1000, cuda) and not PB.pack_handoff(1 << 24, cuda)
    assert PB.handoff_input_ok(cpu) == RB.handoff_input_ok()
    assert not PB.handoff_input_ok(cuda)
    from sheep_tpu_torch.ops.forest import _pipeline_chunks
    assert not _pipeline_chunks(cpu) and _pipeline_chunks(cuda)
    monkeypatch.setenv("SHEEP_HANDOFF_FACTOR", "5")
    monkeypatch.setenv("SHEEP_PACK_HANDOFF", "0")
    monkeypatch.setenv("SHEEP_PIPELINE_CHUNKS", "0")
    assert PB.default_handoff_factor(cuda) == 5
    assert not PB.pack_handoff(1000, cuda)
    assert not _pipeline_chunks(cuda)


@pytest.mark.parametrize("build", ["hybrid", "device"])
def test_hepth_golden_treefaqs(arm, build):
    el = load_edges(HEP)
    fn = PB.build_graph_hybrid if build == "hybrid" else PB.build_graph_device
    seq, forest = fn(el.tail, el.head, device="cpu")
    ref_fn = RB.build_graph_hybrid if build == "hybrid" \
        else RB.build_graph_device
    _same((seq, forest), ref_fn(el.tail, el.head))
    outs = []
    for facts in (PC.compute_facts(forest), compute_facts(forest)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            facts.print()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == (
        "TREEFAQS: width:24\troots:581\n\tvheight:754\teheight:2330\n"
        "\tverts:7610\tedges:15751\n\thalo:3532\tcore:0\n\tfill:0\n")


@pytest.mark.parametrize("seed", range(3))
def test_cuda_default_arm_on_cpu(arm, monkeypatch, seed):
    """The configuration CUDA runs by default (no immediate handoff,
    pipelined chunks, packed fetch, stop at 3n, and on the stream arm the
    device window queue), forced on the CPU for both packages: reduce +
    fetch + fold must agree exactly."""
    monkeypatch.setenv("SHEEP_PIPELINE_CHUNKS", "1")
    monkeypatch.setenv("SHEEP_PACK_HANDOFF", "1")
    monkeypatch.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
    tail, head = rmat_edges(12, 8 << 12, seed=20 + seed)
    n = int(max(tail.max(), head.max())) + 1
    t, h = edges_to_device(tail, head, "cpu")
    _, _, _, lo, hi, pst = PB.prepare_links(t, h, n)
    _, _, _, rlo, rhi, rpst = RB.prepare_links(jnp.asarray(tail),
                                               jnp.asarray(head), n)
    perf = {}
    got = PB.reduce_and_finish_native(lo, hi, n, stop_live=3 * n,
                                      handoff_input=False,
                                      pst_h=pst.numpy().view(np.uint32),
                                      perf=perf)
    kind, a, b, live, rounds = RB.reduce_and_fetch_links(
        rlo, rhi, n, stop_live=3 * n, handoff_input=False)
    assert got[0] == "forest" and kind == "host" and perf["packed_handoff"]
    assert perf.get("stream_mode") == (None if arm == "serial"
                                       else "windowed")
    assert (got[3], got[4]) == (live, rounds)
    want = RB.finish_native_host(a, b, n, np.asarray(rpst).view(np.uint32))
    np.testing.assert_array_equal(got[1], want[0])
    np.testing.assert_array_equal(got[2], want[1])
