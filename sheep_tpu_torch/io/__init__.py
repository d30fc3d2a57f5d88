"""Edge-list readers (trust mode), the crash-safe writer and the block
prefetcher."""

from .atomic import atomic_write
from .edges import EdgeList, iter_dat_blocks, load_edges, read_dat, read_net
from .prefetch import BlockPrefetcher

__all__ = ["BlockPrefetcher", "EdgeList", "atomic_write", "iter_dat_blocks",
           "load_edges", "read_dat", "read_net"]
