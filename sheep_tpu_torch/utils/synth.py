"""Synthetic R-MAT / Graph500-style edges (port of sheep_tpu/utils/synth.py;
the same seed gives the same arrays)."""

from __future__ import annotations

import numpy as np


def rmat_edges(log_n: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT edge records (tail, head) uint32 over 2**log_n vid slots."""
    rng = np.random.default_rng(seed)
    tail = np.zeros(num_edges, dtype=np.uint32)
    head = np.zeros(num_edges, dtype=np.uint32)
    # uint16 entropy: quadrant probabilities quantize to 1/65536
    qa = np.uint16(min(round(a * 65536), 65535))
    qab = np.uint16(min(round((a + b) * 65536), 65535))
    qabc = np.uint16(min(round((a + b + c) * 65536), 65535))
    for bit in range(log_n):
        u = rng.integers(0, 1 << 16, num_edges, dtype=np.uint16)
        tbit = u >= qab
        hbit = ((u >= qa) & (u < qab)) | (u >= qabc)
        tail |= tbit.astype(np.uint32) << np.uint32(bit)
        head |= hbit.astype(np.uint32) << np.uint32(bit)
    return tail, head
