"""Edge-list readers (trust mode)."""

from .edges import EdgeList, iter_dat_blocks, load_edges, read_dat, read_net

__all__ = ["EdgeList", "iter_dat_blocks", "load_edges", "read_dat",
           "read_net"]
