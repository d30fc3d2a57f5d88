"""Tree partitioners, the Partition container, the evaluators and FENNEL
(port of sheep_tpu/partition)."""

from .evaluate import EvalReport, evaluate_partition
from .partition import Partition
from .tree_partition import (TreePartitionOptions, backward_partition,
                             depth_partition, forward_partition,
                             height_partition, make_kids, naive_partition,
                             partition_forest, random_partition)

__all__ = [
    "TreePartitionOptions",
    "forward_partition",
    "backward_partition",
    "depth_partition",
    "height_partition",
    "naive_partition",
    "random_partition",
    "partition_forest",
    "make_kids",
    "Partition",
    "evaluate_partition",
    "EvalReport",
]
