"""The distributed build over a worker mesh (port of sheep_tpu/parallel),
collectives over ``torch.distributed``.

  mesh.py     the Mesh (this process's worker devices, the process
              group, the four collectives), ``make_mesh``,
              ``mesh_devices`` (the device seam), ``init_distributed``
  build.py    ``build_graph_distributed``, ``map_graph_distributed`` and
              the single-dispatch twin ``distributed_build_step``
  chunked.py  the chunked mesh build (global ``pmin`` rounds, the
              gather-tail, the sharded tail) and its streaming build
  stream.py   the fixpoint twin of the mesh streaming build

Every entry point takes ``device=None``, meaning CUDA.
"""

from .build import (build_graph_distributed, distributed_build_step,
                    map_graph_distributed)
from .chunked import (build_graph_chunked_distributed,
                      build_graph_streaming_chunked,
                      build_links_chunked_sharded,
                      map_graph_chunked_distributed, reduce_links_sharded)
from .mesh import (AXIS, Mesh, edge_sharding, init_distributed, make_mesh,
                   mesh_devices, mesh_size, replicated)
from .stream import build_graph_streaming_sharded

__all__ = [
    "build_graph_chunked_distributed",
    "build_graph_streaming_chunked",
    "build_links_chunked_sharded",
    "map_graph_chunked_distributed",
    "reduce_links_sharded",
    "AXIS",
    "make_mesh",
    "init_distributed",
    "edge_sharding",
    "replicated",
    "distributed_build_step",
    "build_graph_distributed",
    "map_graph_distributed",
    "build_graph_streaming_sharded",
    "Mesh",
    "mesh_devices",
    "mesh_size",
]
