"""The distributed build (port of sheep_tpu/parallel), at world size 1.

  build.py  ``build_graph_distributed`` and ``map_graph_distributed``
            for a mesh of one worker: the hybrid build on the card (K1
            through the reduce loop) behind the fast forest self-check,
            or the fault-tolerant build when ``SHEEP_CHECKPOINT_DIR`` is
            set.  A mesh of more than one worker raises
            NotImplementedError until ROADMAP.md §1's ``parallel/`` item
            brings the sharded build over ``torch.distributed``.
"""

from .build import (build_graph_distributed, device_count,
                    map_graph_distributed)

__all__ = ["build_graph_distributed", "device_count",
           "map_graph_distributed"]
