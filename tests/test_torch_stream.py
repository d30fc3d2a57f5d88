"""The port's out-of-core streaming builds (sheep_tpu_torch/ops/stream.py),
its fixpoint (ops/forest.py forest_fixpoint) and its block reader
(io/edges.py iter_dat_blocks) equal sheep_tpu's (JAX on the CPU) and the
whole-graph oracle exactly, for any block size: forests whole, round
counts included.  Mirrors tests/test_stream.py; its sharded and native
host-fold cases belong to modules the port has not taken yet."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_multigraph

import sheep_tpu.ops.forest as RF
import sheep_tpu.ops.stream as RS
from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence, sequence_positions
from sheep_tpu.io.edges import iter_dat_blocks as ref_iter_dat_blocks
from sheep_tpu.io.edges import load_edges as ref_load_edges
from sheep_tpu.io.edges import write_dat

import sheep_tpu_torch.ops.forest as PF
from sheep_tpu_torch.integrity import MalformedArtifact
from sheep_tpu_torch.io import iter_dat_blocks, load_edges
from sheep_tpu_torch.ops import (build_graph_streaming,
                                 build_graph_streaming_hosted,
                                 stream_block_step,
                                 streaming_degree_histogram)
from sheep_tpu_torch.ops.stream import _full_vid_pos
from sheep_tpu_torch.utils import rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")


@pytest.fixture(autouse=True)
def default_knobs(monkeypatch):
    """Both packages on their CPU defaults."""
    for k in ("SHEEP_STREAM_HANDOFF", "SHEEP_OVERLAP_HANDOFF",
              "SHEEP_HANDOFF_FACTOR", "SHEEP_HANDOFF_WINDOWS",
              "SHEEP_STREAM_DEVICE_WINDOWS", "SHEEP_STREAM_HOST_SEQ",
              "SHEEP_PACK_HANDOFF", "SHEEP_DDUP_GRAPH"):
        monkeypatch.delenv(k, raising=False)


def _blocks(tail, head, block):
    for a in range(0, len(tail), block):
        yield tail[a:a + block], head[a:a + block]


def _same_forest(got, want):
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.pst_weight, want.pst_weight)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("block", [7, 64, 10_000])
def test_streaming_matches_oracle(seed, block):
    rng = np.random.default_rng(seed)
    tail, head = random_multigraph(rng, n_max=60, e_max=300)
    seq = degree_sequence(tail, head)
    n_vid = int(max(tail.max(), head.max())) + 1
    n = max(n_vid, len(seq))
    pos = sequence_positions(seq, n - 1)
    forest, rounds = build_graph_streaming(
        _blocks(tail, head, block), n, pos, block_edges=block, device="cpu")
    ref, ref_rounds = RS.build_graph_streaming(
        _blocks(tail, head, block), n, pos, block_edges=block)
    _same_forest(forest, ref)
    assert rounds == ref_rounds
    want = build_forest(tail, head, seq, max_vid=n - 1, impl="python")
    m = len(seq)
    np.testing.assert_array_equal(forest.parent[:m], want.parent)
    np.testing.assert_array_equal(forest.pst_weight[:m], want.pst_weight)
    # slots past the active positions stay empty roots
    assert (forest.pst_weight[m:] == 0).all()


def test_stream_block_step_equals_reference():
    """One block step from a non-empty carry: parent, pst and rounds."""
    rng = np.random.default_rng(23)
    tail, head = random_multigraph(rng, n_max=80, e_max=400)
    seq = degree_sequence(tail, head)
    n = max(int(max(tail.max(), head.max())) + 1, len(seq))
    posx = _full_vid_pos(sequence_positions(seq, n - 1), n)
    half = len(tail) // 2
    parent = np.full(n, n, np.int32)
    pst = np.zeros(n, np.int32)
    pad = len(posx) - 1
    for a, b in ((0, half), (half, len(tail))):
        t = np.full(256, pad, np.int32)
        h = np.full(256, pad, np.int32)
        t[:b - a] = tail[a:b]
        h[:b - a] = head[a:b]
        got = stream_block_step(*(torch.from_numpy(x) for x in
                                  (parent, pst, t, h, posx)), n)
        want = RS.stream_block_step(*(jnp.asarray(x) for x in
                                      (parent, pst, t, h, posx)), n)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2] == int(want[2])
        parent, pst = got[0].numpy(), got[1].numpy()


def test_streaming_degree_histogram():
    rng = np.random.default_rng(17)
    tail, head = random_multigraph(rng, n_max=50, e_max=200)
    n = int(max(tail.max(), head.max())) + 1
    deg = streaming_degree_histogram(_blocks(tail, head, 13), n,
                                     device="cpu")
    ref = np.bincount(tail, minlength=n) + np.bincount(head, minlength=n)
    assert deg.dtype == np.int64
    np.testing.assert_array_equal(deg, ref)
    np.testing.assert_array_equal(
        deg, RS.streaming_degree_histogram(_blocks(tail, head, 13), n))


@pytest.mark.parametrize("kw", [
    {}, {"part": 2, "num_parts": 3}, {"part": 3, "num_parts": 3},
    {"start_edge": 12}, {"end_edge": 31}, {"start_edge": 9, "end_edge": 40},
    {"part": 2, "num_parts": 3, "start_edge": 4, "end_edge": 11},
    {"start_edge": 30, "end_edge": 30}, {"start_edge": 70}])
def test_iter_dat_blocks_roundtrip(tmp_path, kw):
    """Whole files, partial ranges and [start_edge, end_edge) slices: the
    same blocks as the reference's reader, at most 7 records each, and
    the whole file equal to the eager loader."""
    rng = np.random.default_rng(3)
    tail = rng.integers(0, 100, 50).astype(np.uint32)
    head = rng.integers(0, 100, 50).astype(np.uint32)
    path = str(tmp_path / "g.dat")
    write_dat(path, tail, head)
    got = list(iter_dat_blocks(path, 7, **kw))
    want = list(ref_iter_dat_blocks(path, 7, **kw))
    assert len(got) == len(want)
    for (t, h), (rt, rh) in zip(got, want):
        assert len(t) <= 7 and t.dtype == h.dtype == np.uint32
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(h, rh)
    if not kw:
        np.testing.assert_array_equal(np.concatenate([t for t, _ in got]),
                                      tail)
        np.testing.assert_array_equal(np.concatenate([h for _, h in got]),
                                      head)
    if set(kw) == {"part", "num_parts"}:
        el = load_edges(path, **kw)
        np.testing.assert_array_equal(np.concatenate([t for t, _ in got]),
                                      el.tail)


def test_iter_dat_blocks_torn_and_empty(tmp_path):
    """Trust mode: a torn trailing record is dropped (strict, the
    default, refuses it); an empty file yields nothing."""
    path = str(tmp_path / "g.dat")
    write_dat(path, np.arange(10, dtype=np.uint32),
              np.arange(10, dtype=np.uint32)[::-1].copy())
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")
    with pytest.raises(MalformedArtifact):
        list(iter_dat_blocks(path, 4))
    got = list(iter_dat_blocks(path, 4, integrity="trust"))
    assert [len(t) for t, _ in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([t for t, _ in got]),
                                  np.arange(10))
    empty = str(tmp_path / "e.dat")
    open(empty, "wb").close()
    assert list(iter_dat_blocks(empty, 4)) == []


@pytest.mark.parametrize("hosted", [False, True])
def test_streaming_end_to_end_hepth(hosted):
    el = load_edges(HEP)
    seq = degree_sequence(el.tail, el.head)
    n = max(el.max_vid + 1, len(seq))
    pos = sequence_positions(seq, n - 1)
    build = build_graph_streaming_hosted if hosted else build_graph_streaming
    ref_build = RS.build_graph_streaming_hosted if hosted \
        else RS.build_graph_streaming
    forest, rounds = build(_blocks(el.tail, el.head, 4096), n, pos, 4096,
                           device="cpu")
    ref = ref_load_edges(HEP)
    want_forest, want_rounds = ref_build(_blocks(ref.tail, ref.head, 4096),
                                         n, pos, 4096)
    _same_forest(forest, want_forest)
    assert rounds == want_rounds
    want = build_forest(el.tail, el.head, seq)
    m = len(seq)
    np.testing.assert_array_equal(forest.parent[:m], want.parent)
    np.testing.assert_array_equal(forest.pst_weight[:m], want.pst_weight)


@pytest.mark.parametrize("blocksize", [7, 64, 1000])
def test_streaming_hosted_matches_whole(blocksize):
    rng = np.random.default_rng(77)
    tail, head = random_multigraph(rng, 150, 900)
    seq = degree_sequence(tail, head)
    want = build_forest(tail, head, seq)
    pos = sequence_positions(seq, int(max(tail.max(), head.max())))
    perf = {}
    forest, rounds = build_graph_streaming_hosted(
        _blocks(tail, head, blocksize), len(seq), pos.astype(np.int64),
        blocksize, device="cpu", perf=perf)
    ref, ref_rounds = RS.build_graph_streaming_hosted(
        _blocks(tail, head, blocksize), len(seq), pos.astype(np.int64),
        blocksize)
    _same_forest(forest, want)
    _same_forest(forest, ref)
    assert rounds == ref_rounds
    assert perf["blocks"] == -(-len(tail) // blocksize)
    assert perf["block_loop_s"] >= 0 and "loop_s" in perf


@pytest.mark.parametrize("arm", ["serial", "spec"])
def test_streaming_hosted_serial_and_spec_tails(monkeypatch, arm):
    """The hosted build's final fold on the hybrid's other tail arms (the
    serial fetch, and the speculative snapshot forced on), each equal to
    the reference's under the same knobs."""
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "0")
    monkeypatch.setenv("SHEEP_OVERLAP_HANDOFF",
                       "1" if arm == "spec" else "0")
    monkeypatch.setenv("SHEEP_HANDOFF_FACTOR", "1")
    monkeypatch.setenv("SHEEP_OVERLAP_MIN_MB", "0.0001")
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", "512")
    tail, head = rmat_edges(12, 8 << 12, seed=8)
    seq = degree_sequence(tail, head)
    pos = sequence_positions(seq, int(max(tail.max(), head.max())))
    perf = {}
    forest, rounds = build_graph_streaming_hosted(
        _blocks(tail, head, 5000), len(seq), pos, 5000, device="cpu",
        perf=perf)
    ref, ref_rounds = RS.build_graph_streaming_hosted(
        _blocks(tail, head, 5000), len(seq), pos, 5000)
    assert perf["fetch_windows"] == 0
    assert ("spec_mode" in perf) is (arm == "spec")
    _same_forest(forest, ref)
    _same_forest(forest, build_forest(tail, head, seq))
    if arm == "serial":
        # under the speculation the loop stops when a stream has landed,
        # a race with the fetch thread, so only the forest is fixed there
        assert rounds == ref_rounds


@pytest.mark.parametrize("hosted", [False, True])
def test_streaming_sparse_vid_space(hosted):
    """vids far beyond the active count (zero-degree gaps) keep their
    positions: the pos table covers the vid space, not the n active
    slots."""
    rng = np.random.default_rng(55)
    vids = rng.choice(5000, size=60, replace=False).astype(np.uint32)
    tail = rng.choice(vids, 300).astype(np.uint32)
    head = rng.choice(vids, 300).astype(np.uint32)
    seq = degree_sequence(tail, head)
    want = build_forest(tail, head, seq)
    pos = sequence_positions(seq, 4999).astype(np.int64)
    fn = build_graph_streaming_hosted if hosted else build_graph_streaming
    ref_fn = RS.build_graph_streaming_hosted if hosted \
        else RS.build_graph_streaming
    forest, rounds = fn(_blocks(tail, head, 37), len(seq), pos, 37,
                        device="cpu")
    ref, ref_rounds = ref_fn(_blocks(tail, head, 37), len(seq), pos, 37)
    _same_forest(forest, want)
    _same_forest(forest, ref)
    assert rounds == ref_rounds


def test_streaming_empty_stream():
    pos = np.arange(5, dtype=np.int64)
    for fn, ref_fn in ((build_graph_streaming, RS.build_graph_streaming),
                       (build_graph_streaming_hosted,
                        RS.build_graph_streaming_hosted)):
        forest, rounds = fn(iter(()), 5, pos, 8, device="cpu")
        ref, ref_rounds = ref_fn(iter(()), 5, pos, 8)
        _same_forest(forest, ref)
        assert rounds == ref_rounds == 0


def _links(n, e, seed, dead=0.2):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, n - 1, e)
    hi = np.minimum(lo + rng.integers(1, n, e), n - 1)
    keep = lo < hi
    lo, hi = lo[keep], hi[keep]
    mask = rng.random(len(lo)) < dead
    lo[mask] = n
    hi[mask] = n
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("jump_levels", [None, 1, 3, 40])
@pytest.mark.parametrize("n,e", [(2, 5), (50, 300), (700, 2500),
                                 (5000, 40_000)])
def test_forest_fixpoint_equals_reference(n, e, jump_levels):
    """Parent and round count equal the reference's single-dispatch
    while_loop, at several n, jump_levels given and defaulted."""
    lo, hi = _links(n, e, seed=n + e)
    got, rounds = PF.forest_fixpoint(torch.from_numpy(lo),
                                     torch.from_numpy(hi), n,
                                     jump_levels=jump_levels)
    want, want_rounds = RF.forest_fixpoint(jnp.asarray(lo), jnp.asarray(hi),
                                           n, jump_levels=jump_levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)


def test_forest_fixpoint_hub_star_sorts():
    """A hub star unrolls one chain link a jump round until the sort
    rewrite at rounds 7, 15, ...: the round count that schedule gives is
    the reference's."""
    n = 300
    lo = np.zeros(n - 1, np.int32)
    hi = np.arange(1, n, dtype=np.int32)
    got, rounds = PF.forest_fixpoint(torch.from_numpy(lo),
                                     torch.from_numpy(hi), n, jump_levels=1)
    want, want_rounds = RF.forest_fixpoint(jnp.asarray(lo), jnp.asarray(hi),
                                           n, jump_levels=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds) >= 8


def test_forest_fixpoint_empty_and_oracle():
    got, rounds = PF.forest_fixpoint(torch.empty(0, dtype=torch.int32),
                                     torch.empty(0, dtype=torch.int32), 4)
    assert rounds == 0 and got.tolist() == [4, 4, 4, 4]
    tail, head = rmat_edges(10, 8 << 10, seed=2)
    seq = degree_sequence(tail, head)
    pos = sequence_positions(seq, 1023)
    n = len(seq)
    pt = pos[tail].astype(np.int64)
    ph = pos[head].astype(np.int64)
    lo = np.minimum(pt, ph)
    hi = np.maximum(pt, ph)
    dead = (lo >= hi) | (hi >= n)
    lo[dead] = n
    hi[dead] = n
    parent, _ = PF.forest_fixpoint(torch.from_numpy(lo.astype(np.int32)),
                                   torch.from_numpy(hi.astype(np.int32)), n)
    want = build_forest(tail, head, seq)
    p = parent.numpy().astype(np.int64)
    np.testing.assert_array_equal(np.where(p < n, p, 0xFFFFFFFF),
                                  want.parent.astype(np.int64))
