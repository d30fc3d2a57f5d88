"""Analysis utilities — the reference's util/ binaries (SURVEY §2.3).

Each main mirrors one util tool's argument surface and output format:

  tree2dot        .tre -> graphviz digraph              (util/tree2dot.cpp)
  tree2adj        .tre -> METIS adj, sub/super weights  (util/tree2adj.cpp)
  graph2adj       graph -> METIS adj, degree-renumbered (util/graph2adj.cpp)
  vfennel         in-memory fennel + evaluate           (util/vfennel.cpp)
  efennel         streaming edge fennel                 (util/efennel.cpp)
  read_partition  re-evaluate a jnid partition file     (util/read_partition.cpp)
"""

from __future__ import annotations

import sys

import numpy as np

from .. import INVALID_JNID
from ..core.sequence import degree_sequence
from ..io.edges import load_edges
from ..io.trefile import read_tree
from ..partition.evaluate import evaluate_partition
from ..partition.fennel import fennel_edges, fennel_vertex
from ..partition.partition import Partition
from .common import PhaseClock, graph_stats, print_phase_ms


def tree2dot(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("USAGE: graph2dot input_graph output_graph")
        return 1
    clock = PhaseClock()
    parent, _ = read_tree(argv[0])
    print_phase_ms("Loaded", clock.phase_seconds())
    print()
    with open(argv[1], "w") as dot:
        dot.write("digraph {\n")
        for jnid in range(len(parent) - 1, -1, -1):
            line = f"\t{jnid}"
            if parent[jnid] != INVALID_JNID:
                line += f" -> {int(parent[jnid])}"
            dot.write(line + "\n")
        dot.write("}\n")
    print_phase_ms("Finished", clock.phase_seconds())
    return 0


def tree2adj(argv: list[str] | None = None) -> int:
    """METIS format with edge weights min(subtree, edge_width) +
    min(super-tree, edge_width) per tree edge (util/tree2adj.cpp:55-90)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("USAGE: tree2adj input_tree output_graph")
        return 1
    clock = PhaseClock()
    parent, pst = read_tree(argv[0])
    print_phase_ms("Loaded", clock.phase_seconds())
    print()
    n = len(parent)
    par = parent.astype(np.int64)
    par[parent == INVALID_JNID] = -1
    edge_width = pst.astype(np.int64).copy()
    subt = np.ones(n, dtype=np.int64)
    supr = np.ones(n, dtype=np.int64)
    edge_count = 0
    for i in range(n):
        p = par[i]
        if p >= 0:
            edge_count += 1
            edge_width[p] += edge_width[i]  # pre_weight is 0 by default
            subt[p] += subt[i]
    for i in range(n - 1, -1, -1):
        if par[i] >= 0:
            supr[i] += supr[par[i]]
    kids: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        if par[i] >= 0:
            kids[par[i]].append(i)
    with open(argv[1], "w") as adj:
        adj.write(f"{n} {edge_count} 011\n")
        for i in range(n):
            fields = ["1"]
            if par[i] >= 0:
                w = min(subt[i], edge_width[i]) + \
                    min(supr[par[i]], edge_width[i])
                fields.append(f"{par[i] + 1} {w}")
            for k in kids[i]:
                w = min(subt[k], edge_width[k]) + min(supr[i], edge_width[k])
                fields.append(f"{k + 1} {w}")
            adj.write(" ".join(fields) + "\n")
    print_phase_ms("Finished", clock.phase_seconds())
    return 0


def graph2adj(argv: list[str] | None = None) -> int:
    """METIS format, vertices renumbered by the degree sequence
    (util/graph2adj.cpp:55-87); vertex weight = degree, self-loops skipped
    in adjacency."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("USAGE: graph2adj input_graph output_graph")
        return 1
    clock = PhaseClock()
    edges = load_edges(argv[0])
    print_phase_ms("Loaded", clock.phase_seconds())
    print()
    seq = degree_sequence(edges.tail, edges.head)
    index = np.zeros(int(seq.max()) + 1 if len(seq) else 0, dtype=np.int64)
    index[seq] = np.arange(1, len(seq) + 1)

    deg = edges.degrees()
    src = np.concatenate([edges.tail, edges.head]).astype(np.int64)
    dst = np.concatenate([edges.head, edges.tail]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    offs = np.zeros(len(deg) + 1, dtype=np.int64)
    np.add.at(offs, src_s + 1, 1)
    np.cumsum(offs, out=offs)

    edge_cnt = int((np.minimum(edges.tail, edges.head)
                    < np.maximum(edges.tail, edges.head)).sum())
    with open(argv[1], "w") as adj:
        adj.write(f"{len(seq)} {edge_cnt} 010\n")
        for v in seq.tolist():
            nbrs = dst_s[offs[v]:offs[v + 1]]
            nbrs = nbrs[nbrs != v]
            fields = [str(int(deg[v]))] + [str(int(index[y])) for y in nbrs]
            adj.write(" ".join(fields) + "\n")
    print_phase_ms("Finished", clock.phase_seconds())
    return 0


def vfennel(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("USAGE: vfennel graph parts [parts...]")
        return 1
    clock = PhaseClock()
    edges = load_edges(argv[0])
    print_phase_ms("Loaded", clock.phase_seconds())
    nodes, nedges = graph_stats(edges)
    print(f"Nodes:{nodes} Edges:{nedges}")
    for parts_arg in argv[1:]:
        num_parts = int(parts_arg)
        pclock = PhaseClock()
        parts = fennel_vertex(edges.tail, edges.head, num_parts,
                              max_vid=edges.max_vid)
        Partition(parts, num_parts).print()
        print(f"Partitioning took: {int(pclock.phase_seconds() * 1000)}ms")
        evaluate_partition(parts, edges.tail, edges.head, None, num_parts,
                           max_vid=edges.max_vid,
                           file_edges=edges.num_edges).print(with_seq=False)
    print_phase_ms("Finished", clock.total_seconds())
    return 0


def efennel(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("USAGE: fennel graph parts [parts...]")
        return 1
    clock = PhaseClock()
    edges = load_edges(argv[0])
    for parts_arg in argv[1:]:
        num_parts = int(parts_arg)
        pclock = PhaseClock()
        eparts = fennel_edges(edges.tail, edges.head, num_parts,
                              max_vid=edges.max_vid)
        Partition(eparts, num_parts).print()
        print(f"Partitioning took: {int(pclock.phase_seconds() * 1000)}ms")
    print_phase_ms("Finished", clock.total_seconds())
    return 0


def read_partition(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("USAGE: read_partition graph partition [partition...]")
        return 1
    clock = PhaseClock()
    edges = load_edges(argv[0])
    seq = degree_sequence(edges.tail, edges.head)
    print_phase_ms("Loaded", clock.phase_seconds())
    nodes, nedges = graph_stats(edges)
    print(f"Nodes:{nodes} Edges:{nedges}")
    for fname in argv[1:]:
        part = Partition.from_file(seq, fname)
        evaluate_partition(part.parts, edges.tail, edges.head, seq,
                           part.num_parts, max_vid=edges.max_vid,
                           file_edges=edges.num_edges).print()
    print_phase_ms("Finished", clock.phase_seconds())
    return 0
