"""Host oracle: exact sequential semantics in numpy and the native
library, and the treewidth mode (jxn.py)."""

from .facts import Facts, compute_facts
from .forest import (Forest, build_forest, build_forest_links,
                     build_forest_streaming, edges_to_positions,
                     forest_links, merge_forests, pre_weights)
from .jxn import JxnOptions, JxnTree, build_forest_jxn, build_jxn_tree
from .sequence import (default_sequence, degree_sequence,
                       degree_sequence_from_degrees, sequence_positions)
from .validate import check_forest_fast, is_valid_forest

__all__ = ["Facts", "Forest", "JxnOptions", "JxnTree", "build_forest",
           "build_forest_jxn", "build_forest_links",
           "build_forest_streaming", "build_jxn_tree", "check_forest_fast",
           "compute_facts",
           "default_sequence", "degree_sequence",
           "degree_sequence_from_degrees", "edges_to_positions",
           "forest_links", "is_valid_forest", "merge_forests",
           "pre_weights", "sequence_positions"]
