"""Edge-list readers (trust mode) and writers, .tre and .seq files, the
crash-safe writer and the block prefetcher."""

from .atomic import atomic_write
from .edges import (EdgeList, iter_dat_blocks, load_edges, partial_range,
                    read_dat, read_net, write_dat, write_edges, write_net)
from .prefetch import BlockPrefetcher
from .seqfile import read_sequence, write_sequence
from .trefile import read_tree, write_tree

__all__ = ["BlockPrefetcher", "EdgeList", "atomic_write", "iter_dat_blocks",
           "load_edges", "partial_range", "read_dat", "read_net",
           "read_sequence", "read_tree", "write_dat", "write_edges",
           "write_net", "write_sequence", "write_tree"]
