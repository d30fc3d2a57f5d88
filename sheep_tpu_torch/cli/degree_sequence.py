"""degree_sequence: the whole-graph streaming degree sort (port of
sheep_tpu/cli/degree_sequence.py).

Streams the edge file without building adjacency (the reference's
fileSequence, its out-of-memory path), writes the sequence and prints
``Sorted in: Nms``.  ``.dat`` files stream through the block reader, text
``.net`` files through the chunked token parser; only the degree array
is resident either way.  SHEEP_DDUP_GRAPH=1 loads the whole edge set
instead (dedup needs it in memory).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.sequence import (degree_sequence, degree_sequence_from_degrees,
                             host_degree_histogram)
from ..io.edges import iter_dat_blocks, iter_net_blocks, load_edges
from ..io.seqfile import write_sequence
from .common import PhaseClock, maybe_start_heartbeat, print_phase_ms

_BLOCK = 1 << 24  # 16M records (~192MB) per streamed block


def _streamed_sequence(path: str) -> np.ndarray:
    blocks = iter_dat_blocks(path, _BLOCK) if path.endswith(".dat") \
        else iter_net_blocks(path)
    deg = np.zeros(0, dtype=np.int64)
    n = 0
    for tail, head in blocks:
        n_blk = int(max(tail.max(initial=0), head.max(initial=0))) + 1
        n = max(n, n_blk)
        if n > len(deg):  # geometric growth: amortized O(n) total copying
            grown = np.zeros(max(n, 2 * len(deg)), dtype=np.int64)
            grown[: len(deg)] = deg
            deg = grown
        deg[:n_blk] += host_degree_histogram(tail, head, n_blk)
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    return degree_sequence_from_degrees(deg[:n])


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _hb = maybe_start_heartbeat()  # noqa: F841 — beats while we stream
    if len(argv) != 2:
        print("USAGE: degree_sequence graph_file output_file", end="")
        return 1
    clock = PhaseClock()
    if os.environ.get("SHEEP_DDUP_GRAPH", "") != "1":
        seq = _streamed_sequence(argv[0])
    else:
        edges = load_edges(argv[0])
        seq = degree_sequence(edges.tail, edges.head)
    write_sequence(seq, argv[1])
    print_phase_ms("Sorted", clock.total_seconds())
    return 0


if __name__ == "__main__":
    sys.exit(main())
