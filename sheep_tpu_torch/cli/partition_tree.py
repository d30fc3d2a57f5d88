"""partition_tree: load a .tre + sequence, partition, evaluate or write
(port of sheep_tpu/cli/partition_tree.py).

Flag surface and the three modes mirror partition_tree.cpp:40-171:
partition-only print (no -g), partition+evaluate (-g), partition+write
(-g -o).  When no weight flag is given, pst weights are the default
(partition_tree.cpp:95-96).  One intended-behavior fix: the reference's
partition-only loop re-reads ``argv[optind + 2]`` for every trailing parts
argument (an evident indexing slip at :117); here each parts argument is
honored.
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np

from ..core.facts import compute_facts
from ..core.forest import Forest, pre_weights
from ..core.sequence import degree_sequence, sequence_positions
from ..io.edges import iter_dat_blocks, load_edges
from ..io.seqfile import read_sequence
from ..io.trefile import read_tree
from ..partition.evaluate import evaluate_partition, \
    evaluate_partition_streamed
from ..partition.partition import Partition
from ..partition.tree_partition import TreePartitionOptions
from .common import PhaseClock, print_phase

USAGE = ("USAGE: partition_tree [options] input_sequence input_tree parts "
         "[parts...]")

#: .dat record count beyond which the evaluate mode streams blocks through
#: the O(n)-memory evaluator (override: SHEEP_EVAL_STREAM=1 forces it on,
#: =0 off, SHEEP_EVAL_STREAM_THRESHOLD sets the record count).
_STREAM_THRESHOLD = 1 << 27


def _streamed_eval_wanted(graph_filename: str,
                          sequence_filename: str) -> bool:
    if not graph_filename.endswith(".dat") or sequence_filename == "-":
        return False
    if os.environ.get("SHEEP_DDUP_GRAPH", "") == "1":
        # The block reader streams raw records (no load-level dedup), which
        # would silently change every metric; keep the dense path.
        return False
    forced = os.environ.get("SHEEP_EVAL_STREAM")
    if forced is not None:
        return forced == "1"
    threshold = int(os.environ.get("SHEEP_EVAL_STREAM_THRESHOLD",
                                   _STREAM_THRESHOLD))
    try:
        records = os.path.getsize(graph_filename) // 12  # XS1 record size
    except OSError:
        return False
    return records > threshold


def _evaluate_streamed(graph_filename, sequence_filename, forest, popts,
                       pre_weight, parts_args, verbose,
                       block_edges: int = 1 << 24) -> None:
    seq = read_sequence(sequence_filename)
    if pre_weight:
        print("warning: -u is unavailable in streamed evaluation "
              "(pre weights need the in-memory link build); using pst",
              file=sys.stderr)
    # One cheap streaming pass for the vid space + record count.
    mx = len(seq) and int(seq.max())
    file_edges = 0
    for t, h in iter_dat_blocks(graph_filename, block_edges):
        file_edges += len(t)
        mx = max(mx, int(t.max(initial=0)), int(h.max(initial=0)))
    pos = sequence_positions(seq, mx).astype(np.int64)
    factory = lambda: iter_dat_blocks(graph_filename, block_edges)
    for parts_arg in parts_args:
        num_parts = int(parts_arg)
        pclock = PhaseClock()
        part = Partition.from_forest(seq, forest, num_parts, popts,
                                     max_vid=mx)
        if verbose:
            print(f"Partitioning took: {pclock.phase_seconds():f} seconds")
        part.print()
        evaluate_partition_streamed(part.parts, factory, pos, num_parts,
                                    file_edges).print()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "vfb:xdug:o:")
    except getopt.GetoptError as exc:
        o = (exc.opt or "?")[:1]
        if o == "b":
            print(f"Option -{o} requires a double.")
        elif o in ("g", "o"):
            print(f"Option -{o} requires a string.")
        else:
            print(f"Unknown option character '{o}'.")
        return 1

    verbose = True
    do_faqs = False
    balance_factor = 1.03
    vtx_weight = pst_weight = pre_weight = False
    graph_filename = ""
    output_filename = ""

    for o, a in opts:
        if o == "-v":
            verbose = not verbose
        elif o == "-f":
            do_faqs = not do_faqs
        elif o == "-b":
            balance_factor = float(a)
        elif o == "-x":
            vtx_weight = True
        elif o == "-d":
            pst_weight = True
        elif o == "-u":
            pre_weight = True
        elif o == "-g":
            graph_filename = a
        elif o == "-o":
            output_filename = a

    if not (vtx_weight or pst_weight or pre_weight):
        pst_weight = True
    popts = TreePartitionOptions(balance_factor=balance_factor,
                                 vtx_weight=vtx_weight,
                                 pst_weight=pst_weight,
                                 pre_weight=pre_weight)

    if len(args) < 3:
        print(USAGE)
        return 1
    sequence_filename, tree_filename = args[0], args[1]

    clock = PhaseClock()
    parent, pst = read_tree(tree_filename)
    forest = Forest(parent, pst)
    if verbose:
        print_phase("Loaded tree", clock.phase_seconds())
    if do_faqs:
        compute_facts(forest).print()

    if graph_filename == "":
        # Partition-only print.  Without a graph, pre weights cannot be
        # recomputed (the 2-field .tre stores none, like the reference's
        # default non-USE_PRE_WEIGHT build where pre_weight() reads 0) — say
        # so instead of a silent no-op.
        if pre_weight:
            print("warning: -u without -g contributes zero pre_weight "
                  "(pre weights are recomputed from the graph; pass -g)",
                  file=sys.stderr)
        seq = read_sequence(sequence_filename)
        for parts_arg in args[2:]:
            num_parts = int(parts_arg)
            part = Partition.from_forest(seq, forest, num_parts, popts)
            part.print()
    elif output_filename == "":
        # Partition and evaluate.  Large .dat graphs stream through the
        # O(n)-memory evaluator instead of materializing doubled key arrays
        # (which peak ~50 GB at twitter scale); same numbers either way.
        if _streamed_eval_wanted(graph_filename, sequence_filename):
            _evaluate_streamed(graph_filename, sequence_filename, forest,
                               popts, pre_weight, args[2:], verbose)
        else:
            edges = load_edges(graph_filename)
            seq = degree_sequence(edges.tail, edges.head) \
                if sequence_filename == "-" \
                else read_sequence(sequence_filename)
            pre = pre_weights(edges.tail, edges.head, seq,
                              max_vid=edges.max_vid) if pre_weight else None
            for parts_arg in args[2:]:
                num_parts = int(parts_arg)
                pclock = PhaseClock()
                part = Partition.from_forest(seq, forest, num_parts, popts,
                                             max_vid=edges.max_vid, pre=pre)
                if verbose:
                    print(f"Partitioning took: {pclock.phase_seconds():f} "
                          f"seconds")
                part.print()
                evaluate_partition(part.parts, edges.tail, edges.head, seq,
                                   num_parts, max_vid=edges.max_vid,
                                   file_edges=edges.num_edges).print()
    else:
        # Partition and write per-part edge files
        edges = load_edges(graph_filename)
        seq = degree_sequence(edges.tail, edges.head) \
            if sequence_filename == "-" else read_sequence(sequence_filename)
        pre = pre_weights(edges.tail, edges.head, seq,
                          max_vid=edges.max_vid) if pre_weight else None
        num_parts = int(args[2])
        pclock = PhaseClock()
        part = Partition.from_forest(seq, forest, num_parts, popts,
                                     max_vid=edges.max_vid, pre=pre)
        if verbose:
            print(f"Partitioning took: {pclock.phase_seconds():f} seconds")
        part.print()
        part.write_partitioned_graph(edges.tail, edges.head, seq,
                                     output_filename, max_vid=edges.max_vid)

    if verbose:
        print_phase("Finished", clock.total_seconds())
    return 0


if __name__ == "__main__":
    sys.exit(main())
