"""graph2tree: load graph -> sequence -> elimination forest [-> partition]
(port of sheep_tpu/cli/graph2tree.py).

The flag surface, phase lines, files and exit codes are the reference's.
Routes:

  serial        (no -i, no -r) the native host build, ``build_forest``;
                ``-l k/w`` loads a record slice, ``-s`` reads or writes
                the sequence
  -i / -r       the device: a mesh of one worker is the hybrid build on
                the card (``parallel.build_graph_distributed``, whose
                reduce loop launches K1); ``-i`` without ``-r`` and with
                ``-o`` writes the per-worker partial trees
                ``{out}NNr0.tre`` instead
  --checkpoint-dir / --resume / --max-retries
                the fault-tolerant build (``runtime.build_graph_resilient``;
                the serial path's ladder is single -> host)
  -p            partition: print it, or with ``-o`` write the
                partitioned graph

Routes that need a module the port has not ported yet raise SystemExit
naming its ROADMAP.md queue item and never fall back to another route:
the treewidth mode (``-k -e -j -w -x -m``), the external-memory build
(``--ext``, ``SHEEP_EXT_BLOCK``, or a ``SHEEP_MEM_BUDGET`` the in-RAM load
cannot fit), the distributed out-of-core build (``--distext``,
``SHEEP_DISTEXT_LEGS`` >= 2), a mesh of more than one worker and a
multi-host job (``SHEEP_COORDINATOR``).

``main(argv, device=None)``: ``device`` is where the -i/-r and checkpoint
routes run; None means CUDA and raises without it.
"""

from __future__ import annotations

import dataclasses
import getopt
import os
import sys

import numpy as np

from .. import resolve_device, unported
from ..core.facts import compute_facts
from ..core.forest import build_forest
from ..core.sequence import degree_sequence
from ..core.validate import is_valid_forest
from ..io.edges import EdgeList, load_edges, partial_range
from ..io.seqfile import read_sequence, write_sequence
from ..io.trefile import write_tree
from ..ops.sort import degree_sequence_device
from ..parallel.build import (build_graph_distributed, device_count,
                              map_graph_distributed)
from ..partition.partition import Partition
from ..resources.governor import ResourceGovernor
from ..runtime.driver import build_graph_resilient
from ..runtime.snapshot import input_signature
from .common import (PhaseClock, graph_stats, maybe_init_distributed,
                     maybe_start_heartbeat, print_phase, print_tree,
                     runtime_config_from_opts)

USAGE = "USAGE: graph2tree input_graph [options ...]"

_REC_BYTES = 12            # one XS1 record
_INRAM_RECORD_BYTES = 24   # tail/head arrays plus the mapped link pair
_EXT_RECORD_BYTES = 64     # a streamed record's priced peak, ext rung
_EXT_BLOCK_FLOOR = 1 << 14  # the ext rung's smallest block


def _mem_headroom() -> int | None:
    return ResourceGovernor.from_env().mem_headroom()


def extmem_wanted(path: str) -> bool:
    """Where the reference routes a build through its external-memory
    rung (its ``ops.extmem.should_use_extmem``): a ``.dat`` file when
    SHEEP_EXT_BLOCK is set, or when a memory budget cannot hold the
    in-RAM load and prep (24 bytes a record)."""
    if not path.endswith(".dat"):
        return False
    if os.environ.get("SHEEP_EXT_BLOCK", ""):
        return True
    head = _mem_headroom()
    if head is None:
        return False
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        return False
    return (nbytes // _REC_BYTES) * _INRAM_RECORD_BYTES > head


def distext_wanted(path: str) -> bool:
    """Where the reference routes a build through its distributed
    out-of-core job (its ``ops.distext.should_use_distext``): a ``.dat``
    file when SHEEP_DISTEXT_LEGS >= 2, or when even the ext rung's
    floor-sized block stream prices over the memory budget."""
    if not path.endswith(".dat"):
        return False
    spec = os.environ.get("SHEEP_DISTEXT_LEGS", "")
    legs = int(spec) if spec else 0
    if legs < 0:
        raise ValueError(f"SHEEP_DISTEXT_LEGS={legs} must be >= 0")
    if legs >= 2:
        return True
    head = _mem_headroom()
    if head is None:
        return False
    return _EXT_RECORD_BYTES * _EXT_BLOCK_FLOOR > head


def _tree_sig(seq) -> str:
    """Input signature stamped into .tre sidecars: the (n, sequence) the
    tree was built over, shared by the partial trees of one build, so
    merge_trees can refuse a cross-build merge."""
    seq = np.asarray(seq, dtype=np.uint32)
    return input_signature(len(seq), seq)


def _finish_sort(seq, use_mesh_sort, sequence_filename, clock):
    """Write the sequence when `-i -s` asked for it and print the Sorted
    phase line per the reference grammar."""
    if use_mesh_sort and sequence_filename:
        write_sequence(seq, sequence_filename)
    if use_mesh_sort or sequence_filename == "":
        print_phase("Sorted", clock.phase_seconds())


def main(argv: list[str] | None = None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _hb = maybe_start_heartbeat()  # noqa: F841 — beats while we build
    try:
        opts, args = getopt.gnu_getopt(
            argv, "irl:p:s:o:vkejm:w:xfdtc",
            ["checkpoint-dir=", "resume", "max-retries=", "ext",
             "distext"])
    except getopt.GetoptError as exc:
        if (exc.opt or "").startswith(("checkpoint-dir", "max-retries",
                                       "resume", "ext", "distext")):
            print(f"Option --{exc.opt}: {exc.msg}.")
            return 1
        o = (exc.opt or "?")[:1]
        if o in ("s", "o", "l"):
            print(f"Option -{o} requires a string.")
        elif o in ("m", "w", "p"):
            print(f"Option -{o} requires a long long.")
        else:
            print(f"Unknown option character '{o}'.")
        return 1

    use_mesh_sort = use_mesh_reduce = False
    part = num_parts = 0
    partitions = 0
    sequence_filename = ""
    output_filename = ""
    verbose = False
    make_kids = make_pst = make_jxn = find_max_width = False
    width_limit = 0
    do_faqs = do_print = do_validate = False
    use_ext = False
    use_distext = False

    for o, a in opts:
        if o == "-i":
            use_mesh_sort = not use_mesh_sort
        elif o == "-r":
            use_mesh_reduce = not use_mesh_reduce
        elif o == "-l":
            part_s, num_s = a.split("/")
            part, num_parts = int(part_s), int(num_s)
        elif o == "-p":
            partitions = int(a)
        elif o == "-s":
            sequence_filename = a
        elif o == "-o":
            output_filename = a
        elif o == "-v":
            verbose = not verbose
        elif o == "-k":
            make_kids = not make_kids
        elif o == "-e":
            make_pst = not make_pst
        elif o == "-j":
            make_jxn = not make_jxn
        elif o == "-m":
            int(a)  # the memory limit of the treewidth mode
        elif o == "-w":
            width_limit = int(a)
        elif o == "-x":
            find_max_width = not find_max_width
        elif o == "-f":
            do_faqs = not do_faqs
        elif o == "-t":
            do_print = not do_print
        elif o == "-c":
            do_validate = not do_validate
        elif o == "--ext":
            use_ext = True
        elif o == "--distext":
            use_distext = True

    if not args:
        print(USAGE)
        return 1
    graph_filename = args[0]

    rt_cfg = runtime_config_from_opts(opts)

    if make_kids or make_pst or make_jxn or width_limit or find_max_width:
        raise SystemExit(f"graph2tree: -k/-e/-j/-w/-x/-m: the treewidth "
                         f"mode {unported('jxn')}")

    clock = PhaseClock()
    use_mesh = use_mesh_sort or use_mesh_reduce
    if use_mesh:
        maybe_init_distributed()

    # The reference's out-of-core routing, decided before the load: only
    # the serial whole-file .dat path streams, and a request it cannot
    # serve (-p, or distext without -o) falls back as it does there
    if not use_mesh and not num_parts and graph_filename.endswith(".dat"):
        if not use_distext:
            use_distext = distext_wanted(graph_filename)
        if use_distext and (partitions or not output_filename):
            print("warning: the distributed out-of-core build needs -o "
                  "and cannot partition (the edge records never load in "
                  "one process); falling back to the single-process "
                  "path", file=sys.stderr)
            use_distext = False
        if not use_ext and not use_distext:
            use_ext = extmem_wanted(graph_filename)
        if use_ext and partitions and output_filename:
            print("warning: the external-memory build cannot write a "
                  "partitioned graph copy (the edge records never load); "
                  "falling back to the in-RAM path", file=sys.stderr)
            use_ext = False
    else:
        use_ext = use_distext = False
    if use_distext:
        raise SystemExit(f"graph2tree: the distributed out-of-core build "
                         f"(--distext, SHEEP_DISTEXT_LEGS or the memory "
                         f"budget) {unported('distext')}")
    if use_ext:
        raise SystemExit(f"graph2tree: the external-memory build (--ext, "
                         f"SHEEP_EXT_BLOCK or a SHEEP_MEM_BUDGET the "
                         f"in-RAM load cannot fit) {unported('extmem')}")

    if use_mesh or rt_cfg is not None:
        device = resolve_device(device)

    is_leader = use_mesh or sequence_filename == ""
    if verbose:
        print(f"Loading {graph_filename}...")
    if use_mesh and num_parts:
        print(f"warning: -l {part}/{num_parts} is superseded by -i/-r "
              f"(the mesh processes all records, like the reference's "
              f"MPI rank mapping); ignoring -l", file=sys.stderr)
    edges = load_edges(graph_filename, part, num_parts) \
        if not use_mesh else load_edges(graph_filename)
    if verbose:
        nodes, nedges = graph_stats(edges)
        print(f"Nodes:{nodes} Edges:{nedges}")
    if is_leader:
        print_phase("Loaded graph", clock.phase_seconds())

    map_only = False
    if use_mesh:
        count = device_count(device)
        workers = int(os.environ.get("SHEEP_WORKERS") or 0) or count
        mesh_workers = min(workers, count)
        given_seq = None
        if not use_mesh_sort and sequence_filename:
            given_seq = read_sequence(sequence_filename)
        # -i without -r: save exactly `workers` partial trees for the
        # file-path merge (%02dr0.tre names).  A worker count that fits
        # the cards builds them on the card; more workers than cards
        # build partial_range slices on the host, as the reference does
        map_only = (use_mesh_sort and not use_mesh_reduce
                    and output_filename != "" and partitions == 0)
        if map_only:
            if given_seq is not None:
                seq = given_seq
            else:
                seq = degree_sequence_device(edges.tail, edges.head,
                                             device=device)
            _finish_sort(seq, use_mesh_sort, sequence_filename, clock)
            max_vid = edges.max_vid
            if workers <= count and len(edges.tail):
                try:
                    _, partials = map_graph_distributed(
                        edges.tail, edges.head, num_workers=workers,
                        seq=seq, device=device)
                except NotImplementedError as exc:
                    raise SystemExit(f"graph2tree: {exc}")
                sig = _tree_sig(seq)
                for w, f in enumerate(partials):
                    write_tree(f"{output_filename}{w:02d}r0.tre",
                               f.parent, f.pst_weight, sig=sig)
                # -f/-c/-t report worker 0's partial view, like the
                # reference's rank 0 with its partial graph load
                forest = partials[0]
                shard = -(-len(edges.tail) // workers)
                a0, b0 = 0, min(shard, len(edges.tail))
            else:
                forest = None
                sig = _tree_sig(seq)
                for w in range(workers):
                    a, b = partial_range(edges.num_edges, w + 1, workers)
                    f = build_forest(edges.tail[a:b], edges.head[a:b], seq,
                                     max_vid=max_vid)
                    write_tree(f"{output_filename}{w:02d}r0.tre",
                               f.parent, f.pst_weight, sig=sig)
                    if forest is None:
                        forest = f
                        a0, b0 = a, b
            edges = EdgeList(edges.tail[a0:b0], edges.head[a0:b0],
                             file_edges=edges.file_edges, start=a0)
        elif rt_cfg is not None:
            seq, forest = build_graph_resilient(
                edges.tail, edges.head, num_workers=mesh_workers,
                seq=given_seq, max_vid=edges.max_vid, config=rt_cfg,
                device=device)
            _finish_sort(seq, use_mesh_sort, sequence_filename, clock)
        else:
            try:
                seq, forest = build_graph_distributed(
                    edges.tail, edges.head, num_workers=mesh_workers,
                    seq=given_seq, device=device)
            except NotImplementedError as exc:
                raise SystemExit(f"graph2tree: {exc}")
            _finish_sort(seq, use_mesh_sort, sequence_filename, clock)
        if is_leader:
            print_phase("Mapped", clock.phase_seconds())
            if use_mesh_reduce:
                print_phase("Reduced", clock.phase_seconds())
    else:
        if sequence_filename:
            seq = read_sequence(sequence_filename)
        else:
            seq = degree_sequence(edges.tail, edges.head)
        if is_leader:
            print_phase("Sorted", clock.phase_seconds())
        if rt_cfg is not None:
            # the serial path with fault tolerance: the single-chip chunk
            # loop under checkpoint/retry, degrading to the host oracle
            serial_cfg = dataclasses.replace(
                rt_cfg, ladder=("single", "host"))
            _, forest = build_graph_resilient(
                edges.tail, edges.head, seq=seq, max_vid=edges.max_vid,
                config=serial_cfg, device=device)
        else:
            forest = build_forest(edges.tail, edges.head, seq,
                                  max_vid=edges.max_vid)
        if is_leader:
            print_phase("Mapped", clock.phase_seconds())

    max_vid = edges.max_vid
    if partitions != 0:
        p = Partition.from_forest(seq, forest, partitions, max_vid=max_vid)
        if output_filename:
            prefix = output_filename + ("-w0000-p" if use_mesh_reduce else "")
            p.write_partitioned_graph(edges.tail, edges.head, seq, prefix,
                                      max_vid=max_vid)
        elif is_leader:
            p.print()
    elif output_filename and not map_only:
        write_tree(output_filename, forest.parent, forest.pst_weight,
                   sig=_tree_sig(seq))

    if verbose:
        print_phase("Built", clock.total_seconds())
    if do_faqs:
        compute_facts(forest).print()
    if do_print:
        print_tree(seq, forest.parent, forest.pst_weight)
    if do_validate:
        if is_valid_forest(forest, edges.tail, edges.head, seq,
                           max_vid=edges.max_vid):
            print("Tree is valid.")
        else:
            print("ERROR: Tree is not valid.")
    if verbose:
        print_phase("Finished", clock.total_seconds())
    return 0


if __name__ == "__main__":
    sys.exit(main())
