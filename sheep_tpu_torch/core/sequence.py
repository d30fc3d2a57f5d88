"""Vertex elimination orders (port of sheep_tpu/core/sequence.py).

The Sheep order is ascending degree, ties broken by ascending vid, over
the undirected-doubled degree (each record counts both endpoints, a
self-loop counts twice); zero-degree vertices are left out.  That order is
fully defined, so plain numpy computes it — the reference's native
counting-sort shortcuts give the same array.
"""

from __future__ import annotations

import numpy as np


def host_degree_histogram(tail: np.ndarray, head: np.ndarray,
                          n: int) -> np.ndarray:
    """Undirected-doubled degrees: each record adds 1 to both endpoints."""
    return (np.bincount(tail, minlength=n)
            + np.bincount(head, minlength=n)).astype(np.int64)


def degree_sequence_from_degrees(deg: np.ndarray) -> np.ndarray:
    """Sequence from a dense degree histogram (vid-indexed)."""
    vids = np.nonzero(deg)[0]
    # vids ascend, so a stable sort by degree breaks ties by vid
    order = np.argsort(deg[vids], kind="stable")
    return vids[order].astype(np.uint32)


def degree_sequence(tail: np.ndarray, head: np.ndarray,
                    num_vertices: int | None = None) -> np.ndarray:
    """Ascending-degree sequence from edge records (whole graph)."""
    n = num_vertices
    if n is None:
        n = int(max(tail.max(initial=0), head.max(initial=0))) + 1 \
            if len(tail) else 0
    return degree_sequence_from_degrees(host_degree_histogram(tail, head, n))


def sequence_positions(seq: np.ndarray,
                       max_vid: int | None = None) -> np.ndarray:
    """Invert a sequence into a vid->position map; 0xFFFFFFFF where absent."""
    n = int(max_vid) + 1 if max_vid is not None else \
        (int(seq.max()) + 1 if len(seq) else 0)
    n = max(n, int(seq.max()) + 1 if len(seq) else 0)
    pos = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    pos[seq] = np.arange(len(seq), dtype=np.uint32)
    return pos
