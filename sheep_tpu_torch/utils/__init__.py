"""Synthetic graphs."""

from .synth import rmat_edges

__all__ = ["rmat_edges"]
