"""Edge-list readers (strict, repair and trust integrity modes) and
writers, .tre and .seq files, the crash-safe writer and the block
prefetcher."""

from .atomic import atomic_write
from .edges import (EdgeList, dedup_edges, iter_dat_blocks, iter_net_blocks,
                    load_edges, partial_range, read_dat, read_net, write_dat,
                    write_edges, write_net)
from .prefetch import BlockPrefetcher
from .seqfile import read_sequence, write_sequence
from .trefile import read_tree, write_tree

__all__ = ["BlockPrefetcher", "EdgeList", "atomic_write", "dedup_edges",
           "iter_dat_blocks", "iter_net_blocks", "load_edges",
           "partial_range", "read_dat", "read_net", "read_sequence", "read_tree", "write_dat", "write_edges",
           "write_net", "write_sequence", "write_tree"]
