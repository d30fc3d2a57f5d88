"""Entry ``hybrid``: ``graph2tree -i -r`` on one card,
``build_graph_hybrid`` on host edges, which it uploads itself.

A build returns the sequence it made and the forest; the reference
works all three out again from the records.
"""

from __future__ import annotations

from harness import reference
from harness.graph import Graph

#: the traffic file's own keys that this entry reads
PARAMS = ()
#: each number compared, with its limit: an exact build
LIMITS = {"seq_diff": 0, "parent_diff": 0, "pst_diff": 0}


class Hybrid:
    def __init__(self, graph: Graph, traffic: dict, device):
        self.graph = graph
        self.device = device

    def build(self, perf: dict | None = None) -> dict:
        from sheep_tpu_torch.ops.build import build_graph_hybrid

        seq, forest = build_graph_hybrid(self.graph.tail, self.graph.head,
                                         perf=perf, device=self.device)
        return {"seq": seq, "parent": forest.parent,
                "pst": forest.pst_weight}


def make(graph: Graph, traffic: dict, device) -> Hybrid:
    return Hybrid(graph, traffic, device)


def expected(graph: Graph, traffic: dict, device) -> dict:
    return reference.expected(graph.tail, graph.head, graph.vid_slots,
                              device)
