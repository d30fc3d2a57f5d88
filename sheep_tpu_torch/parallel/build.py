"""The `-i -r` build (port of sheep_tpu/parallel/build.py), world size 1.

The reference runs ``graph2tree -i``/``-r`` as one SPMD program over a
mesh of ``min(SHEEP_WORKERS or devices, devices)`` workers, and routes a
mesh of one through its flagship hybrid build followed by the fast
forest oracle (``_selfcheck_forest``).  On one card every `-i -r` run is
that branch, so it is what this module ports: ``build_graph_hybrid`` on
the card, whose reduce loop launches K1.  A mesh of more than one worker
needs the sharded build (collectives over ``torch.distributed``) and
raises NotImplementedError naming its ROADMAP.md queue item.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device, unported
from ..core.validate import check_forest_fast
from ..integrity.errors import IntegrityError
from ..ops.build import build_graph_hybrid
from ..runtime.driver import build_graph_resilient


def device_count(device: torch.device) -> int:
    """Devices a mesh can span: the CUDA card count on CUDA, 1 on the
    CPU (the port has no virtual CPU mesh)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _one_worker(num_workers: int | None, device: torch.device) -> None:
    """Raise unless the mesh, ``min(num_workers or count, count)``
    workers, is one worker."""
    count = device_count(device)
    size = min(num_workers or count, count)
    if size > 1:
        raise NotImplementedError(
            f"a mesh of {size} workers needs the sharded build, which "
            f"{unported('parallel')}")


def _selfcheck_forest(seq, forest, what: str):
    """Run the vectorised fast oracle (core.validate.check_forest_fast)
    on the forest this path hands downstream: O(n) numpy on the host,
    and it turns a wrong answer from a sick card into a typed
    IntegrityError where it happened.  SHEEP_SELFCHECK=0 opts out."""
    if os.environ.get("SHEEP_SELFCHECK", "1") == "0":
        return seq, forest
    problems = check_forest_fast(forest)
    if problems:
        raise IntegrityError(
            f"{what} produced an invalid forest: " + "; ".join(problems))
    return seq, forest


def build_graph_distributed(tail: np.ndarray, head: np.ndarray,
                            num_vertices: int | None = None,
                            num_workers: int | None = None,
                            seq: np.ndarray | None = None, device=None):
    """Host-facing distributed build: (seq uint32 [m], Forest over m).

    ``seq``: a given elimination order (`-r` without `-i`); None runs the
    degree sort.  ``device`` None is CUDA (RuntimeError without it).
    SHEEP_CHECKPOINT_DIR reroutes through the fault-tolerant runtime
    (``runtime.build_graph_resilient``), bit-identical; otherwise a mesh
    of one worker is ``ops.build.build_graph_hybrid`` with the forest
    self-check."""
    device = resolve_device(device)
    if os.environ.get("SHEEP_CHECKPOINT_DIR"):
        return build_graph_resilient(tail, head, num_vertices=num_vertices,
                                     num_workers=num_workers, seq=seq,
                                     device=device)
    _one_worker(num_workers, device)
    return _selfcheck_forest(
        *build_graph_hybrid(tail, head, num_vertices=num_vertices, seq=seq,
                            device=device), what="hybrid build")


def map_graph_distributed(tail: np.ndarray, head: np.ndarray,
                          num_vertices: int | None = None,
                          num_workers: int | None = None,
                          seq: np.ndarray | None = None, device=None):
    """Map-only (`-i` without `-r`): (seq uint32 [m], [Forest over m] * W).

    One worker's partial covers every record, so it is the whole-graph
    hybrid tree; more workers raise NotImplementedError."""
    device = resolve_device(device)
    _one_worker(num_workers, device)
    out_seq, forest = build_graph_hybrid(tail, head,
                                         num_vertices=num_vertices, seq=seq,
                                         device=device)
    if len(out_seq) == 0:
        return out_seq, []
    return out_seq, [forest]
