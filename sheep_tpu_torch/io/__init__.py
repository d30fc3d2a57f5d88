"""Edge-list readers (trust mode)."""

from .edges import EdgeList, load_edges, read_dat, read_net

__all__ = ["EdgeList", "load_edges", "read_dat", "read_net"]
