"""Vid-indexed partition container + writers (port of
sheep_tpu/partition/partition.py).

Mirrors the reference's Partition surface (lib/partition.h:45-192): holds a
vid-indexed part array (INVALID_PART = -1 where a vid is absent from the
sequence), prints the "Actually created N partitions" summary
(partition.h:135-143), writes per-part edge files with downward edge
assignment (partition.cpp:588-681) and the isomorphic renumbered graph
(partition.cpp:528-586).
"""

from __future__ import annotations

import numpy as np

from .. import INVALID_PART
from ..core.forest import Forest
from ..core.sequence import sequence_positions
from ..io.edges import write_net, write_dat
from .tree_partition import TreePartitionOptions, partition_forest


class Partition:
    def __init__(self, parts: np.ndarray, num_parts: int):
        self.parts = parts.astype(np.int64)  # vid-indexed
        self.num_parts = int(num_parts)

    @classmethod
    def from_forest(cls, seq: np.ndarray, forest: Forest, num_parts: int,
                    opts: TreePartitionOptions | None = None,
                    strategy: str = "forward",
                    max_vid: int | None = None,
                    pre: np.ndarray | None = None) -> "Partition":
        jparts = partition_forest(forest, num_parts, opts, strategy, pre=pre)
        n = int(max_vid) + 1 if max_vid is not None else 0
        n = max(n, (int(seq.max()) + 1) if len(seq) else 0)
        vparts = np.full(n, INVALID_PART, dtype=np.int64)
        vparts[seq] = jparts
        return cls(vparts, num_parts)

    @classmethod
    def from_file(cls, seq: np.ndarray, filename: str) -> "Partition":
        """jnid-indexed parts file -> vid-indexed (lib/partition.h:55-65)."""
        jparts = np.loadtxt(filename, dtype=np.int64, ndmin=1)
        num_parts = int(jparts.max()) + 1
        n = (int(seq.max()) + 1) if len(seq) else 0
        vparts = np.full(n, INVALID_PART, dtype=np.int64)
        vparts[seq] = jparts[: len(seq)]
        return cls(vparts, num_parts)

    @property
    def max_part(self) -> int:
        return int(self.parts.max(initial=0))

    def print(self) -> None:
        print(f"Actually created {self.max_part + 1} partitions.")
        first = int((self.parts == 0).sum())
        second = int((self.parts == 1).sum())
        print(f"First two partition sizes: {first} and {second}")

    def write_partitioned_graph(self, tail: np.ndarray, head: np.ndarray,
                                seq: np.ndarray, output_prefix: str,
                                max_vid: int | None = None,
                                fmt: str = "net") -> list[str]:
        """Per-part edge files, edge -> part of its earlier-in-sequence
        endpoint (partition.cpp:623).  Edges written once, (min,max) vid
        orientation; self-loops skipped (directed-iteration X<Y filter,
        partition.cpp:616-617)."""
        if self.max_part >= 10000:  # writer name format, partition.cpp:598
            raise ValueError(f"{self.max_part + 1} parts exceed the 4-digit "
                             f"part file names")
        pos = sequence_positions(seq, max_vid).astype(np.int64)
        a = np.minimum(tail, head).astype(np.int64)
        b = np.maximum(tail, head).astype(np.int64)
        keep = a != b
        a, b = a[keep], b[keep]
        down_is_a = pos[a] < pos[b]
        edge_part = np.where(down_is_a, self.parts[a], self.parts[b])
        paths = []
        writer = write_dat if fmt == "dat" else write_net
        for p in range(self.max_part + 1):
            sel = edge_part == p
            path = f"{output_prefix}{p:04d}"
            writer(path, a[sel].astype(np.uint32), b[sel].astype(np.uint32))
            paths.append(path)
        return paths

    def write_isomorphic_graph(self, tail: np.ndarray, head: np.ndarray,
                               seq: np.ndarray, output_filename: str,
                               max_vid: int | None = None) -> None:
        """Renumber so parts are contiguous in the new id space
        (partition.cpp:528-553): stable-sort seq by part, then write each
        undirected edge once as (new_x, new_y) with new_x < new_y."""
        order = np.argsort(self.parts[seq], kind="stable")
        new_seq = seq[order]
        pos = sequence_positions(new_seq, max_vid).astype(np.int64)
        pa = pos[tail.astype(np.int64)]
        pb = pos[head.astype(np.int64)]
        keep = pa != pb
        lo = np.minimum(pa[keep], pb[keep])
        hi = np.maximum(pa[keep], pb[keep])
        write_net(output_filename, lo.astype(np.uint32), hi.astype(np.uint32))
