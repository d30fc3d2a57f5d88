"""Device ops on torch tensors: the port of sheep_tpu/ops.

``build`` holds the in-memory entry points (``build_graph_hybrid``,
``build_graph_device``); ``stream`` the out-of-core ones
(``build_graph_streaming``, ``build_graph_streaming_hosted``); ``forest``
the reduce loop and the fixpoint; ``sort`` the prep; ``fused_jump`` the
wrapper of kernel K1 (csrc/fused_jump.cu); ``probe`` the backend probe's
kernels P1 and P2 (csrc/probe_kernels.cu).
"""

from .build import build_graph_device, build_graph_hybrid
from .forest import (forest_fixpoint, forest_fixpoint_hosted,
                     reduce_links_hosted)
from .stream import (build_graph_streaming, build_graph_streaming_hosted,
                     stream_block_step, streaming_degree_histogram)

__all__ = ["build_graph_device", "build_graph_hybrid",
           "build_graph_streaming", "build_graph_streaming_hosted",
           "forest_fixpoint", "forest_fixpoint_hosted",
           "reduce_links_hosted", "stream_block_step",
           "streaming_degree_histogram"]
