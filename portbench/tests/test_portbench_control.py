"""The comparison catches what it has to: each control (the reference in
the program's place with one guarantee broken) and each fault the cells
can have, planted under a run driven on the CPU at a tiny size.  The
cells run on one card, so there is no exchange between chips to leave
out."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import REPO, tiny_spec
from harness import session
from harness.controls import KINDS, Control
from harness.spec import Spec

CELLS = Spec.load(REPO).cell_names()


def _run(spec, cell, hook=None, seed=2**31 + 9):
    result, _ = session.run_cell(spec, cell, seed, 0.2, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 entry_hook=hook)
    return result


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", KINDS)
def test_control_comes_out_wrong(tmp_path, cell, kind):
    spec = tiny_spec(tmp_path)
    result = _run(spec, cell, lambda e: Control(e, kind))
    assert result["correct"] is False
    diffs = {k: v["value"] for k, v in result["check"].items()}
    assert max(diffs.values()) > 0


class _HalfRecords:
    """Half of the records left out of every build."""

    def __init__(self, entry):
        self.entry = entry
        g = entry.graph
        half = g.records // 2
        entry.graph = type(g)(g.tail[:half], g.head[:half], g.vid_slots)

    def build(self, perf=None):
        return self.entry.build(perf)


def _fold_unchanged(monkeypatch):
    """The fold's step returns its state unchanged: no window folds."""
    from sheep_tpu_torch import native
    monkeypatch.setattr(native.LinksFold, "block", lambda self, lo, hi: None)


def _answer_altered(monkeypatch):
    """One parent altered where the fold produces it."""
    from sheep_tpu_torch import native
    finish = native.LinksFold.finish

    def altered(self):
        parent, pst = finish(self)
        parent = parent.copy()
        k = int(np.flatnonzero(parent != 0xFFFFFFFF)[0])
        parent[k] = 0xFFFFFFFF
        return parent, pst

    monkeypatch.setattr(native.LinksFold, "finish", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_fault_comes_out_wrong(tmp_path, monkeypatch, cell, fault):
    spec = tiny_spec(tmp_path)
    hook = None
    if fault == "state_unchanged":
        _fold_unchanged(monkeypatch)
    elif fault == "answer_altered":
        _answer_altered(monkeypatch)
    else:
        hook = _HalfRecords
    result = _run(spec, cell, hook)
    assert result["correct"] is False
    assert result["check"]["parent_diff"]["value"] > 0 \
        or result["check"]["pst_diff"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_reads_zero(tmp_path, cell):
    """The lower reading: sound runs read 0 on every number."""
    spec = tiny_spec(tmp_path)
    for seed in (1, 2, 2**31 + 1):
        result = _run(spec, cell, seed=seed)
        assert result["correct"] is True
        assert all(v["value"] == 0 for v in result["check"].values())


def test_a_failing_build_counts(tmp_path):
    spec = tiny_spec(tmp_path)

    class Fails:
        def __init__(self, entry):
            self.entry = entry
            self.calls = 0

        def build(self, perf=None):
            self.calls += 1
            if self.calls > 1:  # the warm-up passes, the window's fail
                raise RuntimeError("planted")
            return self.entry.build(perf)

    result = _run(spec, "lj.build", Fails)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert result["check"]["builds_failed"]["value"] == result["failed"]
