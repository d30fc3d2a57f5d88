"""Host oracle: exact sequential semantics in numpy and the native fold."""

from .facts import Facts, compute_facts
from .forest import (Forest, build_forest, build_forest_links,
                     edges_to_positions)
from .sequence import (degree_sequence, degree_sequence_from_degrees,
                       sequence_positions)

__all__ = ["Facts", "Forest", "build_forest", "build_forest_links",
           "compute_facts", "degree_sequence",
           "degree_sequence_from_degrees", "edges_to_positions",
           "sequence_positions"]
