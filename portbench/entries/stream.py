"""Entry ``stream``: the out-of-core build,
``build_graph_streaming_hosted`` over host blocks of ``block_records``
records, with the degree sequence given, as a user's ``.seq`` file
gives it (``graph2tree -s``).

The sequence is worked out once, in set-up, by the benchmark's own
plain code.  A build returns the forest; the sequence is an input, not
an answer, so only ``parent`` and ``pst`` are compared.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import reference
from harness.graph import Graph

PARAMS = ("block_records",)
LIMITS = {"parent_diff": 0, "pst_diff": 0}


class Stream:
    def __init__(self, graph: Graph, traffic: dict, device):
        self.graph = graph
        self.device = device
        self.block = int(traffic["block_records"])
        self.seq = sequence_given(graph, device)
        self.n = len(self.seq)
        pos = np.full(graph.vid_slots, reference.ROOT, dtype=np.uint32)
        pos[self.seq] = np.arange(self.n, dtype=np.uint32)
        self.pos = pos

    def blocks(self):
        t, h, b = self.graph.tail, self.graph.head, self.block
        for s in range(0, len(t), b):
            yield t[s:s + b], h[s:s + b]

    def build(self, perf: dict | None = None) -> dict:
        from sheep_tpu_torch.ops.stream import build_graph_streaming_hosted

        forest, _ = build_graph_streaming_hosted(
            self.blocks(), self.n, self.pos, self.block, perf=perf,
            device=self.device)
        return {"parent": forest.parent, "pst": forest.pst_weight}


def sequence_given(graph: Graph, device) -> np.ndarray:
    """The degree sequence a user's ``.seq`` file would hold, worked out
    by the benchmark's own plain code on ``device``."""
    t = torch.from_numpy(graph.tail.astype(np.int64)).to(device)
    h = torch.from_numpy(graph.head.astype(np.int64)).to(device)
    seq = reference.degree_sequence(t, h, graph.vid_slots)
    return seq.cpu().numpy().astype(np.uint32)


def make(graph: Graph, traffic: dict, device) -> Stream:
    return Stream(graph, traffic, device)


def expected(graph: Graph, traffic: dict, device) -> dict:
    """The reference works the sequence out again, and the forest under
    it."""
    return reference.expected(graph.tail, graph.head, graph.vid_slots,
                              device)
