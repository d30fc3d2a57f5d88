"""Vertex elimination orders (port of sheep_tpu/core/sequence.py).

The Sheep order is ascending degree, ties broken by ascending vid, over
the undirected-doubled degree (each record counts both endpoints, a
self-loop counts twice); zero-degree vertices are left out
(lib/sequence.h:52-63).  As in the reference, the native library's
fused histogram and counting sort compute it; numpy's stable sort takes
over only where the counting sort gives up (a degree range too wide for
its buckets), which is the reference's own dispatch.
"""

from __future__ import annotations

import numpy as np


def host_degree_histogram(tail: np.ndarray, head: np.ndarray,
                          n: int) -> np.ndarray:
    """Undirected-doubled degrees through the native histogram: each
    record adds 1 to both endpoints."""
    from .. import native
    return native.degree_histogram(tail, head, n)


def degree_sequence_from_degrees(deg: np.ndarray,
                                 impl: str = "auto") -> np.ndarray:
    """Sequence from a dense degree histogram (vid-indexed).  ``impl``
    "python" skips the native counting sort."""
    if impl != "python":
        from .. import native
        seq = native.degree_sequence_from_degrees(deg)
        if seq is not None:  # None: degree range too wide for buckets
            return seq
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
    from .. import native
    if native.blocked_enabled():
        # fused kernel (uint32 histogram + counting sort in one call);
        # None: the range outgrew its buckets, take the two-call path
        seq = native.degree_sequence_from_edges(tail, head, n)
        if seq is not None:
            return seq
    return degree_sequence_from_degrees(host_degree_histogram(tail, head, n))


def default_sequence(deg: np.ndarray) -> np.ndarray:
    """Vertices in vid order, degree-0 skipped (lib/sequence.h:43-50)."""
    return np.nonzero(deg)[0].astype(np.uint32)


def sequence_positions(seq: np.ndarray,
                       max_vid: int | None = None) -> np.ndarray:
    """Invert a sequence into a vid->position map; 0xFFFFFFFF where absent."""
    n = int(max_vid) + 1 if max_vid is not None else \
        (int(seq.max()) + 1 if len(seq) else 0)
    n = max(n, int(seq.max()) + 1 if len(seq) else 0)
    pos = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    pos[seq] = np.arange(len(seq), dtype=np.uint32)
    return pos
