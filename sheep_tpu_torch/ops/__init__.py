"""Device ops on torch tensors: the port of sheep_tpu/ops.

``build`` holds the entry points (``build_graph_hybrid``,
``build_graph_device``); ``forest`` the reduce loop; ``sort`` the prep;
``fused_jump`` the wrapper of kernel K1 (csrc/fused_jump.cu).
"""
