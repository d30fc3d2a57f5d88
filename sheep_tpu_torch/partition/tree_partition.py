"""Tree partitioning algorithms (port of
sheep_tpu/partition/tree_partition.py; host, exact reference semantics).

``forward_partition`` is the paper algorithm (lib/partition.cpp:86-157): one
ascending pass accumulates the uncut component weight below each node; when a
node's component overflows ``max_component`` its kids' subtrees are first-fit-
decreasing bin-packed into parts; a descending pass then inherits parts from
parents and packs remaining roots (scanning bins from the most recently
opened, matching :146).  Bins (``part_size``) are global across the whole
pass.

Weight model (lib/partition.cpp:38-48): ``vtx_weight`` adds 1 per node,
``pst_weight`` adds the node's postorder edge count (the default,
partition_tree.cpp:95-96), ``pre_weight`` adds kids' preorder weights — the
reference only populates those under a non-default compile flag
(USE_PRE_WEIGHT, defs.h off by default), so here an optional ``pre`` array
may be supplied; absent, it contributes zero exactly like the reference's
default build.

Determinism note: the reference sorts kids by component weight with an
*unstable* ``std::sort`` (partition.cpp:104-106), so tie order — and
therefore exact part assignments — are implementation-defined there.  We use
a stable sort with ascending-jnid tie-break, making output deterministic;
quality metrics agree with the reference's published numbers (golden-tested
on hep-th).

These numpy/python loops are the semantics oracle; the port's native
library (csrc/sheep_native.cpp) runs the forward pass under
``impl="auto"``, which raises when the library cannot build.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import INVALID_JNID, INVALID_PART
from ..core.forest import Forest


@dataclass
class TreePartitionOptions:
    balance_factor: float = 1.03
    vtx_weight: bool = False
    pst_weight: bool = True
    pre_weight: bool = False


def node_weights(forest: Forest, opts: TreePartitionOptions,
                 pre: np.ndarray | None = None) -> np.ndarray:
    n = forest.n
    w = np.zeros(n, dtype=np.int64)
    if opts.vtx_weight:
        w += 1
    if opts.pst_weight:
        w += forest.pst_weight.astype(np.int64)
    if opts.pre_weight and pre is not None:
        # sum of kids' pre_weight == own pre contribution routed via parent
        kid_pre = np.zeros(n, dtype=np.int64)
        valid = forest.parent != INVALID_JNID
        np.add.at(kid_pre, forest.parent[valid].astype(np.int64),
                  pre[valid].astype(np.int64))
        w += kid_pre
    return w


def make_kids(parent: np.ndarray) -> list[np.ndarray]:
    """Kid lists in ascending-jnid order (lib/jnode.h:190-204 makeKids)."""
    n = len(parent)
    par = parent.astype(np.int64)
    par[parent == INVALID_JNID] = -1
    order = np.arange(n)
    valid = par >= 0
    kids: list[np.ndarray] = [np.empty(0, dtype=np.int64)] * n
    if valid.any():
        p = par[valid]
        k = order[valid]
        srt = np.argsort(p, kind="stable")  # groups by parent, kids ascending
        p, k = p[srt], k[srt]
        starts = np.searchsorted(p, np.arange(n), side="left")
        stops = np.searchsorted(p, np.arange(n), side="right")
        for i in range(n):
            if stops[i] > starts[i]:
                kids[i] = k[starts[i]:stops[i]]
    return kids


def forward_partition(forest: Forest, max_component: int,
                      weights: np.ndarray) -> np.ndarray:
    """The paper algorithm: ascending FFD pass + descending inheritance."""
    n = forest.n
    parent = forest.parent
    parts = np.full(n, INVALID_PART, dtype=np.int64)
    component_below = weights.astype(np.int64).copy()
    if n and int(weights.max()) > max_component:
        # The reference trips its live assert here (partition.cpp:114); in a
        # release build it would loop forever opening empty bins.  Fail fast:
        # a single node heavier than max_component can never be packed.
        raise ValueError(
            f"max_component {max_component} smaller than the heaviest node "
            f"({int(weights.max())}); request fewer partitions or a larger "
            f"balance factor")
    kids = make_kids(parent)
    part_size: list[int] = []

    for i in range(n):
        if component_below[i] > max_component:
            ks = kids[i]
            # descending component weight, stable (ascending jnid ties),
            # as the native pass does; the reference's unstable std::sort
            # leaves ties toolchain-defined (the note in sheep_native.cpp)
            ks = ks[np.argsort(-component_below[ks], kind="stable")]
            while component_below[i] > max_component:
                for kid in ks:
                    if component_below[i] <= max_component:
                        break
                    if parts[kid] != INVALID_PART:
                        continue
                    cb = component_below[kid]
                    for cur in range(len(part_size)):
                        if part_size[cur] + cb <= max_component:
                            component_below[i] -= cb
                            part_size[cur] += cb
                            parts[kid] = cur
                            break
                if component_below[i] > max_component:
                    part_size.append(0)
        p = parent[i]
        if p != INVALID_JNID:
            component_below[p] += component_below[i]

    # Descending pass: inherit from parent; pack roots from the last bin back.
    for i in range(n - 1, -1, -1):
        if parts[i] == INVALID_PART and parent[i] != INVALID_JNID:
            parts[i] = parts[parent[i]]
        while parts[i] == INVALID_PART:
            for cur in range(len(part_size) - 1, -1, -1):
                if part_size[cur] + component_below[i] <= max_component:
                    part_size[cur] += component_below[i]
                    parts[i] = cur
                    break
            if parts[i] == INVALID_PART:
                part_size.append(0)
    return parts


def backward_partition(forest: Forest, max_component: int,
                       weights: np.ndarray) -> np.ndarray:
    """Critical-path packing experiment (lib/partition.cpp:159-199)."""
    n = forest.n
    parent = forest.parent
    parts = np.full(n, INVALID_PART, dtype=np.int64)
    component_below = weights.astype(np.int64).copy()
    for i in range(n):
        p = parent[i]
        if p != INVALID_JNID:
            component_below[p] += component_below[i]

    kids = make_kids(parent)
    critical = int(np.argmax(component_below))
    while len(kids[critical]):
        ks = kids[critical]
        critical = int(ks[np.argmax(component_below[ks])])
        component_below[parent[critical]] -= component_below[critical]

    cur_part = 0
    size = 0
    c = critical
    while c != -1:
        if size + component_below[c] < max_component:
            parts[c] = cur_part
            size += component_below[c]
        else:
            cur_part += 1
            parts[c] = cur_part
            size = component_below[c]
        p = parent[c]
        c = int(p) if p != INVALID_JNID else -1

    for i in range(n - 1, -1, -1):
        if parts[i] == INVALID_PART:
            parts[i] = parts[parent[i]] if parent[i] != INVALID_JNID else cur_part
    return parts


def _chunked_by_order(order: np.ndarray, weights: np.ndarray,
                      max_component: int) -> np.ndarray:
    parts = np.empty(len(order), dtype=np.int64)
    cur_part = 0
    size = 0
    for idx in order:
        parts[idx] = cur_part
        size += int(weights[idx])
        if size >= max_component:
            cur_part += 1
            size = 0
    return parts


def depth_partition(forest: Forest, max_component: int,
                    weights: np.ndarray) -> np.ndarray:
    """Deepest-first chunking (lib/partition.cpp:202-225)."""
    n = forest.n
    parent = forest.parent
    depth = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        if parent[i] != INVALID_JNID:
            depth[i] = depth[parent[i]] + 1
    order = np.argsort(-depth, kind="stable")
    return _chunked_by_order(order, weights, max_component)


def height_partition(forest: Forest, max_component: int,
                     weights: np.ndarray) -> np.ndarray:
    """Lowest-height-first chunking (lib/partition.cpp:228-251)."""
    n = forest.n
    parent = forest.parent
    height = np.zeros(n, dtype=np.int64)
    for i in range(n):
        p = parent[i]
        if p != INVALID_JNID and height[p] < height[i] + 1:
            height[p] = height[i] + 1
    order = np.argsort(height, kind="stable")
    return _chunked_by_order(order, weights, max_component)


def naive_partition(forest: Forest, max_component: int,
                    weights: np.ndarray) -> np.ndarray:
    """Sequence-order chunking (lib/partition.cpp:253-266)."""
    return _chunked_by_order(np.arange(forest.n), weights, max_component)


def random_partition(n: int, num_parts: int, seed: int | None = None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_parts, size=n).astype(np.int64)


_STRATEGIES = {
    "forward": forward_partition,
    "backward": backward_partition,
    "depth": depth_partition,
    "height": height_partition,
    "naive": naive_partition,
}


def partition_forest(forest: Forest, num_parts: int,
                     opts: TreePartitionOptions | None = None,
                     strategy: str = "forward",
                     pre: np.ndarray | None = None,
                     impl: str = "auto") -> np.ndarray:
    """jnid-indexed part assignment (lib/partition.cpp:50-61)."""
    opts = opts or TreePartitionOptions()
    weights = node_weights(forest, opts, pre)
    total = int(weights.sum())
    max_component = int((total // max(num_parts, 1)) * opts.balance_factor)
    if strategy == "forward":
        from ..core.forest import native_or_none
        native = native_or_none(impl)
        if native is not None:
            return native.forward_partition(
                forest.parent, weights, max_component).astype(np.int64)
    return _STRATEGIES[strategy](forest, max_component, weights)
