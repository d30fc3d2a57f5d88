"""Device ops on torch tensors, and the torch-free external-memory build:
the port of sheep_tpu/ops.

``build`` holds the in-memory entry points (``build_graph_hybrid``,
``build_graph_device``); ``stream`` the out-of-core ones
(``build_graph_streaming``, ``build_graph_streaming_hosted``); ``forest``
the reduce loop and the fixpoint; ``sort`` the prep; ``fused_jump`` the
wrapper of kernel K1 (csrc/fused_jump.cu); ``probe`` the backend probe's
kernels P1 and P2 (csrc/probe_kernels.cu); ``extmem`` the
external-memory build over a ``.dat`` file and ``distext`` its supervised
distributed form (record-slice legs, the histogram Allreduce, the
tournament merge), both host code.

Resolution is lazy (PEP 562), as in the reference: importing this
package, or its torch-free members ``ops.extmem`` and ``ops.distext``,
loads no torch.  The out-of-core builds must fit ``SHEEP_MEM_BUDGET``,
and torch's baseline footprint would be most of a small budget.
``from sheep_tpu_torch.ops import build_graph_hybrid`` loads torch at
that moment.
"""

_LAZY = {
    # .sort
    "degree_sequence_device": "sort",
    # .forest
    "forest_fixpoint": "forest",
    "forest_fixpoint_hosted": "forest",
    "reduce_links_hosted": "forest",
    "links_from_parent": "forest",
    "merge_parents": "forest",
    "build_forest_device": "forest",
    "merge_forests_device": "forest",
    # .build
    "build_step": "build",
    "build_graph_device": "build",
    "build_graph_hybrid": "build",
    # .stream
    "build_graph_streaming": "stream",
    "build_graph_streaming_hosted": "stream",
    "stream_block_step": "stream",
    "streaming_degree_histogram": "stream",
    # .extmem (torch-free)
    "build_forest_extmem": "extmem",
    "range_degree_histogram": "extmem",
    "should_use_extmem": "extmem",
    "streaming_degree_sequence": "extmem",
    # .distext (torch-free)
    "run_distext": "distext",
    "should_use_distext": "distext",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value  # cache: the next access skips the lookup
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
