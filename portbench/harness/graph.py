"""The benchmark's graphs: Graph500 Kronecker (R-MAT) edge records drawn
on the device from a seed.

The recipe is ``sheep_tpu_torch/utils/synth.py``'s ``rmat_edges`` (one
16-bit draw per record and bit; the quadrant probabilities quantised to
1/65536), redone in torch so that the draws run on the card: a host
draw of 2^26 records takes some 20 s.  The Graph500 specification also
permutes the vertex labels, so a seeded permutation relabels both
endpoints.  Duplicate records and self-loops are kept, as the generator
makes them.  The same seed on the same device type gives the same
records.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Graph:
    """Edge records in host memory, as a user's loaded ``.dat`` holds
    them: ``tail`` and ``head`` uint32 [records] over ``vid_slots``."""

    tail: np.ndarray
    head: np.ndarray
    vid_slots: int

    @property
    def records(self) -> int:
        return len(self.tail)


def _quantised(p: float) -> int:
    return min(round(p * 65536), 65535)


def rmat_device(log_n: int, records: int, seed: int, device,
                a: float = 0.57, b: float = 0.19, c: float = 0.19,
                permute: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """R-MAT records (tail, head) as int32 tensors on ``device`` over
    2**log_n vid slots.  Per bit, one draw u in [0, 65536) picks the
    quadrant: tail's bit is set in C and D, head's in B and D."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    qa, qab, qabc = _quantised(a), _quantised(a + b), _quantised(a + b + c)
    tail = torch.zeros(records, dtype=torch.int32, device=device)
    head = torch.zeros(records, dtype=torch.int32, device=device)
    for bit in range(log_n):
        u = torch.randint(0, 1 << 16, (records,), generator=g,
                          device=device, dtype=torch.int32)
        tail |= (u >= qab).to(torch.int32) << bit
        head |= (((u >= qa) & (u < qab)) | (u >= qabc)).to(torch.int32) << bit
        del u
    if permute:
        perm = torch.randperm(1 << log_n, generator=g, device=device,
                              dtype=torch.int64).to(torch.int32)
        tail = perm[tail.long()]
        head = perm[head.long()]
    return tail, head


def make_graph(spec: dict, seed: int, device) -> Graph:
    """The configuration's graph (its ``graph`` block) for ``seed``,
    drawn on ``device`` and copied once to host memory."""
    if spec["generator"] != "graph500_kronecker":
        raise ValueError(f"unknown generator {spec['generator']!r}")
    log_n = int(spec["log_vid_slots"])
    tail, head = rmat_device(log_n, int(spec["records"]), seed, device,
                             spec["a"], spec["b"], spec["c"],
                             spec["permute_labels"])
    tail_h = tail.cpu().numpy().view(np.uint32)
    head_h = head.cpu().numpy().view(np.uint32)
    return Graph(tail_h, head_h, 1 << log_n)
