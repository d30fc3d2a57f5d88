"""Host oracle: exact sequential semantics in numpy and the native fold."""

from .facts import Facts, compute_facts
from .forest import (Forest, build_forest, build_forest_links,
                     edges_to_positions, forest_links)
from .sequence import (degree_sequence, degree_sequence_from_degrees,
                       sequence_positions)
from .validate import check_forest_fast, is_valid_forest

__all__ = ["Facts", "Forest", "build_forest", "build_forest_links",
           "check_forest_fast", "compute_facts", "degree_sequence",
           "degree_sequence_from_degrees", "edges_to_positions",
           "forest_links", "is_valid_forest", "sequence_positions"]
