"""The port's out-of-core streaming builds (sheep_tpu_torch/ops/stream.py)
and its block reader (io/edges.py iter_dat_blocks) equal sheep_tpu's
(JAX on the CPU) and the whole-graph oracle exactly, for any block size:
forests whole, round counts included (the fixpoint under them is
tests/test_torch_fixpoint.py's).  Mirrors tests/test_stream.py; its sharded and native
host-fold cases belong to modules the port has not taken yet."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import random_multigraph

import sheep_tpu.ops.stream as RS
from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence, sequence_positions
from sheep_tpu.io.edges import iter_dat_blocks as ref_iter_dat_blocks
from sheep_tpu.io.edges import load_edges as ref_load_edges
from sheep_tpu.io.edges import write_dat

from sheep_tpu_torch.integrity import MalformedArtifact
from sheep_tpu_torch.io import iter_dat_blocks, load_edges
from sheep_tpu_torch.ops import (build_graph_streaming,
                                 build_graph_streaming_hosted,
                                 stream_block_step,
                                 streaming_degree_histogram)
from sheep_tpu_torch.ops.stream import (_block_buffers, _device_vid_pos,
                                        _full_vid_pos, _padded_block)
from sheep_tpu_torch.utils import rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEP = os.path.join(REPO, "data", "hep-th.dat")


@pytest.fixture(autouse=True)
def default_knobs(monkeypatch):
    """Both packages on their CPU defaults."""
    for k in ("SHEEP_STREAM_HANDOFF", "SHEEP_HANDOFF_FACTOR",
              "SHEEP_HANDOFF_WINDOWS", "SHEEP_STREAM_DEVICE_WINDOWS",
              "SHEEP_STREAM_HOST_SEQ", "SHEEP_PACK_HANDOFF",
              "SHEEP_DDUP_GRAPH"):
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


INTAKE_SLOTS, INTAKE_BLOCK, INTAKE_N = 1000, 64, 600
INVALID = 0xFFFFFFFF


def _intake_case(case, rng):
    """(tail, head, pos) for one case of the block intake."""
    tail = rng.integers(0, INTAKE_SLOTS, INTAKE_BLOCK).astype(np.uint32)
    head = rng.integers(0, INTAKE_SLOTS, INTAKE_BLOCK).astype(np.uint32)
    # a permutation over more slots than positions: entries >= n
    pos = rng.permutation(INTAKE_SLOTS).astype(np.uint32)
    if case == "short":
        tail, head = tail[:37], head[:37]
    elif case == "one":
        tail, head = tail[:1], head[:1]
    elif case == "wrap":
        tail = np.array([INTAKE_SLOTS - 1, 1 << 31, INVALID, (1 << 31) + 5,
                         0], np.uint32)
        head = tail[::-1].copy()
    elif case == "strided":
        tail, head = tail[::2], head[1::2]
        assert not tail.flags.c_contiguous
    elif case == "int64":
        tail = tail.astype(np.int64)
        head = head.astype(np.int64)
        tail[:3] = [INTAKE_SLOTS - 1, (1 << 32) + 7, -2]
    elif case == "pos_invalid":
        pos[::7] = INVALID
        pos[3::11] = (1 << 31) + 3
    elif case == "pos_int32":
        pos = pos.astype(np.int32)
        pos[::5] = -1
    elif case == "pos_int64":
        pos = pos.astype(np.int64)
        pos[::5] = -1
        pos[1::9] = (1 << 32) + 2
    return tail, head, pos


@pytest.mark.parametrize("case", ["full", "short", "one", "wrap", "strided",
                                  "int64", "pos_invalid", "pos_int32",
                                  "pos_int64"])
def test_block_intake_equals_the_int64_route(case):
    """The device-side intake (each block's exact records uploaded as
    int32 into reused buffers and padded there; the position table mapped
    there) gives the tensors of the int64 host route it replaced: the
    padded block's ``astype(np.int32)`` and ``_full_vid_pos``."""
    tail, head, pos = _intake_case(case, np.random.default_rng(31))
    vid_pad = len(pos)
    buf = _block_buffers(INTAKE_BLOCK, "cpu")
    for x in buf:
        x.fill_(-7)  # what a block before this one left
    nbytes = []
    got = _padded_block(tail, head, buf, vid_pad, upload_bytes=nbytes)
    b = len(tail)
    for g, x in zip(got, (tail, head)):
        want = np.full(INTAKE_BLOCK, vid_pad, np.int64)
        want[:b] = x
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want.astype(np.int32))
    assert nbytes == [8 * b]
    posx = _device_vid_pos(pos, INTAKE_N, "cpu")
    want = _full_vid_pos(pos, INTAKE_N)
    assert posx.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(posx.numpy(), want)


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
    """The hosted build's final fold on the hybrid's other tail shapes:
    the serial fetch, and ("spec", the case's old name) the card's window
    queue forced on with 6-byte packing, 512-link slices and 4 windows;
    each equal to the reference's under the same knobs."""
    if arm == "serial":
        monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "0")
    else:
        monkeypatch.setenv("SHEEP_STREAM_DEVICE_WINDOWS", "1")
        monkeypatch.setenv("SHEEP_PACK_HANDOFF", "1")
        monkeypatch.setenv("SHEEP_HANDOFF_WINDOWS", "4")
    monkeypatch.setenv("SHEEP_HANDOFF_FACTOR", "1")
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
    if arm == "serial":
        assert perf["fetch_windows"] == 0 and "stream_mode" not in perf
    else:
        assert perf["stream_mode"] == "windowed", perf
        assert perf["packed_handoff"] is True and perf["fetch_windows"] >= 1
    _same_forest(forest, ref)
    _same_forest(forest, build_forest(tail, head, seq))
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
