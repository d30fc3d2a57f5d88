"""The handoff past 2^24 positions: ``pack_handoff`` packs a link into 6
bytes only where n < 2^24, so a wider build crosses as int32 pairs of 8
bytes on every arm (the streamed windows, three of them or one of the
smallest slices, and the serial fetch).  Each case reduces links that
lie at the top of the position space, hands them off with packing asked
for, and holds parent and pst to the benchmark's plain reference
(``portbench/harness/reference.py``: ``links_and_pst``,
``forest_union_find``), and the bytes the handoff counts
(``ops.build.handoff_bytes``, ``perf["handoff_bytes"]``, the spans'
``bytes``) to 8 or 6 a fetched link.

The reference runs on the links' own span of positions: the forest is a
function of the positions' order alone, so shifting every link by one
offset shifts the forest by it, and positions no link touches are
roots with pst 0."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import sheep_tpu_torch.ops.build as PB
from sheep_tpu_torch.obs import trace as obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "portbench_reference",
    os.path.join(REPO, "portbench", "harness", "reference.py"))
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)

#: positions the links span, at the top of the position space
SPAN = 3000
LINKS = 40_000
INVALID = 0xFFFFFFFF

ARMS = {
    "stream": {"SHEEP_STREAM_HANDOFF": "1",
               "SHEEP_STREAM_DEVICE_WINDOWS": "1",
               "SHEEP_HANDOFF_WINDOWS": "3"},
    "serial": {"SHEEP_STREAM_HANDOFF": "0"},
    "stream1": {"SHEEP_STREAM_HANDOFF": "1",
                "SHEEP_STREAM_DEVICE_WINDOWS": "1",
                "SHEEP_HANDOFF_WINDOWS": "1"},
}


@pytest.fixture(params=sorted(ARMS))
def arm(request, monkeypatch):
    """The handoff arm with the card's defaults forced on the CPU:
    pipelined chunks, packing asked for, 512-link slices."""
    for k in ("SHEEP_HANDOFF_WINDOWS", "SHEEP_STREAM_DEVICE_WINDOWS",
              "SHEEP_HANDOFF_FACTOR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHEEP_PIPELINE_CHUNKS", "1")
    monkeypatch.setenv("SHEEP_PACK_HANDOFF", "1")
    monkeypatch.setenv("SHEEP_OVERLAP_SLICE", "512")
    for k, v in ARMS[request.param].items():
        monkeypatch.setenv(k, v)
    return request.param


def _links(seed: int):
    """Random multigraph records on SPAN positions, duplicates kept."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, SPAN, LINKS)
    v = (u + rng.geometric(0.01, LINKS)) % SPAN
    return torch.from_numpy(u), torch.from_numpy(v)


def _wanted(u, v, n: int):
    """The reference's parent and pst over n positions for the records
    (u, v) shifted to the top SPAN positions."""
    lo, hi, pst = reference.links_and_pst(u, v, torch.arange(SPAN), SPAN)
    parent = reference.forest_union_find(lo.numpy(), hi.numpy(), SPAN)
    off = n - SPAN
    want_parent = np.full(n, INVALID, np.uint32)
    want_parent[off:] = np.where(parent < 0, INVALID, parent + off)
    want_pst = np.zeros(n, np.uint32)
    want_pst[off:] = pst.numpy()
    return lo + off, hi + off, want_parent, want_pst


@pytest.mark.parametrize("n, packed", [((1 << 24) + 5, False),
                                       ((1 << 24) - 5, True)])
def test_handoff_on_both_sides_of_2_24(arm, n, packed):
    u, v = _links(n % 97)
    lo, hi, want_parent, want_pst = _wanted(u, v, n)
    assert int(hi.max()) == n - 1 and int(lo.min()) == n - SPAN
    live = len(lo)
    perf = {}
    before = PB.handoff_bytes
    with obs.capture() as cap:
        got = PB.reduce_and_finish_native(
            lo.to(torch.int32), hi.to(torch.int32), n, stop_live=live // 4,
            pst_h=want_pst.copy(), perf=perf)
    kind, parent, pst, _, rounds = got
    assert kind == "forest" and rounds > 0
    assert perf["packed_handoff"] is packed
    assert perf.get("stream_mode") == (None if arm == "serial"
                                       else "windowed")
    np.testing.assert_array_equal(parent, want_parent)
    np.testing.assert_array_equal(pst, want_pst)

    # the bytes: each fetch's own arrays, 8 or 6 bytes a fetched slot
    bpl = 6 if packed else 8
    fetches = cap.named("handoff.slice") + cap.named("handoff.fetch")
    fetched = sum(sp.attrs["links"] for sp in fetches)
    assert fetches and fetched >= perf["handoff_links"] > 0
    assert sum(sp.attrs["bytes"] for sp in fetches) == bpl * fetched
    assert perf["handoff_bytes"] == PB.handoff_bytes - before \
        == bpl * fetched
    if arm == "serial":
        assert cap.named("handoff.fold")[0].attrs["packed"] is packed
        assert cap.named("handoff.fetch")[0].attrs["packed"] is packed
    else:
        tail = cap.named("handoff.tail")[0]
        assert tail.attrs["bytes"] == perf["handoff_bytes"]
        assert tail.attrs["packed"] is packed
        if arm == "stream1":
            assert tail.attrs["windows"] == 1


def test_converged_build_fetches_nothing(monkeypatch):
    """A loop that converges before the threshold hands nothing off: the
    build counts 0 bytes."""
    monkeypatch.setenv("SHEEP_STREAM_HANDOFF", "1")
    u, v = _links(5)
    lo, hi, want_parent, _ = _wanted(u, v, SPAN)
    perf = {}
    got = PB.reduce_and_finish_native(lo.to(torch.int32), hi.to(torch.int32),
                                      SPAN, stop_live=1, perf=perf)
    assert got[0] == "device" and perf["handoff_bytes"] == 0
    parent = PB.parent_from_links(got[1], got[2], SPAN).numpy()
    np.testing.assert_array_equal(
        np.where(parent >= SPAN, INVALID, parent).astype(np.uint32),
        want_parent)
