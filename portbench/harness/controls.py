"""Controls: the reference put in the program's place with one guarantee
of the configuration broken.  The comparison has to find each of them
wrong (``tools/readings.py`` on the card, ``tests`` on the CPU).

- ``dedupe``: duplicate records dropped before the build, the step a
  faster build would be tempted to take; breaks "duplicates are kept
  and counted" (the degrees, the sequence and pst change);
- ``ties``: equal degrees ordered by descending vid; breaks "ties by
  ascending vid" (the sequence, and with it the forest, change).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference


def _dedupe(tail: np.ndarray, head: np.ndarray, device):
    key = torch.from_numpy(tail.astype(np.int64) << 32
                           | head.astype(np.int64)).to(device)
    key = torch.unique(key).cpu().numpy()
    return (key >> 32).astype(np.uint32), \
        (key & 0xFFFFFFFF).astype(np.uint32)


def _ties_reversed(tail: np.ndarray, head: np.ndarray, vid_slots: int,
                   device) -> np.ndarray:
    t = torch.from_numpy(tail.astype(np.int64)).to(device)
    h = torch.from_numpy(head.astype(np.int64)).to(device)
    # relabel v -> V-1-v, take the sequence, map back: ties now descend
    flip = vid_slots - 1
    seq = reference.degree_sequence(flip - t, flip - h, vid_slots)
    return (flip - seq).cpu().numpy().astype(np.uint32)


class Control:
    """An entry whose builds are the reference's, with one guarantee
    broken.  ``entry`` is the cell's own entry: its graph, and its given
    sequence where it has one."""

    def __init__(self, entry, kind: str):
        if kind not in KINDS:
            raise ValueError(f"unknown control {kind!r}; known: {KINDS}")
        self.entry = entry
        self.kind = kind

    def build(self, perf: dict | None = None) -> dict:
        g = self.entry.graph
        tail, head = g.tail, g.head
        seq = getattr(self.entry, "seq", None)
        if self.kind == "dedupe":
            tail, head = _dedupe(tail, head, self.entry.device)
        elif self.kind == "ties":
            seq = _ties_reversed(tail, head, g.vid_slots, self.entry.device)
        return reference.expected(tail, head, g.vid_slots, self.entry.device,
                                  seq=seq)


KINDS = ("dedupe", "ties")
