"""``handoff_gib``, the bytes a build's handoff copies off the card as the
program counts them, and the cell past 2^24 vid slots that crosses in
8-byte pairs (``g500.build``)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from conftest import REPO
from harness.session import Build, Run
from harness.spec import Spec
from sheep_tpu_torch.ops.build import pack_handoff

SPEC = Spec.load(REPO)


def _run(perfs):
    builds = [Build(float(i), float(i + 1), None, p)
              for i, p in enumerate(perfs)]
    return Run(cell=None, graph=SimpleNamespace(records=1000), setup_s=1.0,
               builds=builds)


def test_handoff_gib_reads_the_program_s_bytes():
    read = SPEC.reader("handoff_gib")
    run = _run([{"handoff_bytes": 6 * 2**29}, {"handoff_bytes": 8 * 2**29},
                None])
    assert read(run) == pytest.approx(3.5)
    # a parent without the counter, or nothing fetched: nothing to read
    assert read(_run([{"loop_s": 0.1}])) is None
    assert read(_run([{"handoff_bytes": 0}])) is None
    assert read(_run([])) is None


def test_the_cell_past_2_24_runs_the_hybrid_unpacked():
    cell = SPEC.cell("g500.build")
    graph = cell.config["graph"]
    assert graph["log_vid_slots"] == 25 and graph["records"] == 16 << 25
    assert cell.traffic["entry"] == "hybrid"
    assert cell.config["reduced"] == {}
    assert "handoff_gib" in [m["name"] for m in cell.per_layer]
    # the entry's build is over the vid slots, which no packing fits
    assert not pack_handoff(1 << graph["log_vid_slots"],
                            torch.device("cuda"))
    assert pack_handoff(1 << 23, torch.device("cuda"))
