"""graph2tree: load graph -> sequence -> elimination forest [-> partition]
(port of sheep_tpu/cli/graph2tree.py).

The flag surface, phase lines, files and exit codes are the reference's.
Routes:

  serial        (no -i, no -r) the native host build, ``build_forest``;
                ``-l k/w`` loads a record slice, ``-s`` reads or writes
                the sequence
  -i / -r       the device mesh of ``min(SHEEP_WORKERS or devices,
                devices)`` workers (``parallel.build_graph_distributed``:
                one worker is the hybrid build, more the chunked sharded
                build; every worker's rounds launch K1 on the card);
                ``-i`` without ``-r`` and with ``-o`` writes the
                per-worker partial trees ``{out}NNr0.tre`` instead.
                Under SHEEP_COORDINATOR / SHEEP_NUM_PROCESSES /
                SHEEP_PROCESS_ID the processes join one mesh over
                ``torch.distributed`` (the reference's ``mpiexec``), and
                only process 0 prints phase lines and writes files
  --ext         the external-memory build (``ops.extmem``): the serial
                whole-file ``.dat`` path streamed in blocks, the edge list
                never loaded; also taken under ``SHEEP_EXT_BLOCK`` or a
                ``SHEEP_MEM_BUDGET`` the in-RAM load cannot fit
  -k -e -j -w -x -m
                the treewidth mode (``core.jxn``): the host insert with
                kids/pst/jxn tables; with ``-i``/``-r`` the degree sort
                runs on the card first
  --checkpoint-dir / --resume / --max-retries
                the fault-tolerant build (``runtime.build_graph_resilient``;
                the serial path's ladder is single -> host); with
                ``--ext`` the block checkpoints of the external-memory
                build
  -p            partition: print it, or with ``-o`` write the
                partitioned graph
  --distext     the distributed out-of-core build (``ops.distext``):
                the tournament supervisor's hist -> Allreduce -> map ->
                merge job over record slices of the ``.dat``, each leg a
                process of its own (``cli.distext``); also taken under
                ``SHEEP_DISTEXT_LEGS`` >= 2 or a ``SHEEP_MEM_BUDGET``
                below the ext rung's floor block.  Its state dir is
                ``--checkpoint-dir`` or ``<out>.distext``; a rerun
                resumes off the fsck'd survivors.  Legs priced (or
                pinned) to ship to remote workers wait for the serving
                tier and fail naming its ROADMAP.md queue item

Only the routes that reach the card load torch: ``-i``/``-r`` and the
serial ``--checkpoint-dir`` build.  Every other route (serial, ``-l``,
``-p``, ``-s``, ``--ext``, ``--distext`` and its legs, the treewidth
mode without ``-i``/``-r``) runs in a process that never imports it,
as the reference's never imports jax: ``SHEEP_MEM_BUDGET`` routes by the
headroom left over the process's RSS, so the two packages must price the
same process.

``main(argv, device=None)``: ``device`` is where the card routes run;
None means CUDA and raises without it.
"""

from __future__ import annotations

import dataclasses
import getopt
import os
import sys

import numpy as np

from .. import resolve_device
from ..core.facts import compute_facts
from ..core.forest import build_forest
from ..core.sequence import degree_sequence
from ..core.validate import is_valid_forest
from ..io.edges import EdgeList, load_edges, partial_range
from ..io.seqfile import read_sequence, write_sequence
from ..io.trefile import write_tree
from ..partition.partition import Partition
from ..runtime.snapshot import input_signature
from .common import (PhaseClock, graph_stats, maybe_init_distributed,
                     maybe_start_heartbeat, print_phase, print_tree,
                     runtime_config_from_opts)

USAGE = "USAGE: graph2tree input_graph [options ...]"


def _tree_sig(seq) -> str:
    """Input signature stamped into .tre sidecars: the (n, sequence) the
    tree was built over, shared by the partial trees of one build, so
    merge_trees can refuse a cross-build merge."""
    seq = np.asarray(seq, dtype=np.uint32)
    return input_signature(len(seq), seq)


def _make_jopts(make_kids, make_pst, make_jxn, memory_limit, width_limit,
                find_max_width):
    from ..core.jxn import JxnOptions
    return JxnOptions(make_kids=make_kids, make_pst=make_pst,
                      make_jxn=make_jxn,
                      memory_limit=memory_limit or (1 << 30),
                      width_limit=width_limit,
                      find_max_width=find_max_width)


def _finish_sort(seq, use_mesh_sort, sequence_filename, clock,
                 leader=True, writer=True):
    """Write the sequence when `-i -s` asked for it and print the Sorted
    phase line per the reference grammar.  ``leader``/``writer`` gate the
    print and the write in a multi-process job (the other processes hold
    the same replicated results)."""
    if use_mesh_sort and sequence_filename and writer:
        write_sequence(seq, sequence_filename)
    if (use_mesh_sort or sequence_filename == "") and leader:
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
    make_kids = make_pst = make_jxn = False
    memory_limit = 0
    width_limit = 0
    find_max_width = False
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
            memory_limit = int(a) * (1 << 20)
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

    clock = PhaseClock()
    use_mesh = use_mesh_sort or use_mesh_reduce
    is_leader = use_mesh or sequence_filename == ""
    proc0 = True  # this process writes the shared-filesystem outputs
    if use_mesh:
        # a multi-process job joins before any device work; only process
        # 0 leads and writes (the reference's rank-0 logic,
        # graph2tree.cpp:158-159): every process computes the same
        # replicated result
        device = resolve_device(device)
        if maybe_init_distributed(device) != 0:
            is_leader = False
            proc0 = False

    jxn_mode = make_kids or make_pst or make_jxn or width_limit or \
        find_max_width

    # The reference's out-of-core routing, decided before the load (the
    # edge list must never enter RAM): only the serial whole-file .dat
    # path streams, and a request it cannot serve (-p with -o, or distext
    # without -o) falls back as it does there
    if not use_mesh and not jxn_mode and not num_parts \
            and graph_filename.endswith(".dat"):
        if not use_distext:
            from ..ops.distext import should_use_distext
            use_distext = should_use_distext(graph_filename)
        if use_distext and (partitions or not output_filename):
            print("warning: the distributed out-of-core build needs -o "
                  "and cannot partition (the edge records never load in "
                  "one process); falling back to the single-process "
                  "path", file=sys.stderr)
            use_distext = False
        if not use_ext and not use_distext:
            from ..ops.extmem import should_use_extmem
            use_ext = should_use_extmem(graph_filename)
        if use_ext and partitions and output_filename:
            print("warning: the external-memory build cannot write a "
                  "partitioned graph copy (the edge records never load); "
                  "falling back to the in-RAM path", file=sys.stderr)
            use_ext = False
    else:
        use_ext = use_distext = False
    if use_distext:
        # the supervised distributed job: the supervisor owns the whole
        # hist -> Allreduce -> map -> merge lifecycle and prints the
        # reference phase grammar itself; the state dir doubles as the
        # checkpoint surface, so a rerun resumes off the fsck'd survivors
        from ..integrity.errors import IntegrityError
        from ..ops.distext import run_distext
        from ..supervisor import (SupervisionFailed, SupervisorConfig,
                                  SupervisorKilled)
        state_dir = (rt_cfg.checkpoint_dir if rt_cfg is not None else
                     None) or output_filename + ".distext"
        try:
            run_distext(graph_filename, state_dir,
                        SupervisorConfig.from_env(),
                        out_file=output_filename)
        except (SupervisionFailed, SupervisorKilled, IntegrityError,
                OSError) as exc:
            print(f"graph2tree: distext: {exc}", file=sys.stderr)
            return 1
        if verbose:
            print_phase("Finished", clock.total_seconds())
        return 0

    # the card routes: -i/-r, and the serial build under --checkpoint-dir
    # (its single rung); everything else stays on the host without torch
    if use_mesh or (rt_cfg is not None and not use_ext and not jxn_mode):
        device = resolve_device(device)

    if verbose:
        print(f"Loading {graph_filename}...")
    if use_mesh and num_parts:
        print(f"warning: -l {part}/{num_parts} is superseded by -i/-r "
              f"(the mesh processes all records, like the reference's "
              f"MPI rank mapping); ignoring -l", file=sys.stderr)
    if use_ext:
        edges = None  # the stream IS the load; downstream guards on None
    else:
        edges = load_edges(graph_filename, part, num_parts) \
            if not use_mesh else load_edges(graph_filename)
        if verbose:
            nodes, nedges = graph_stats(edges)
            print(f"Nodes:{nodes} Edges:{nedges}")
    if is_leader:
        print_phase("Loaded graph", clock.phase_seconds())

    widths = None
    map_only = False
    if use_mesh and jxn_mode:
        # the kids/pst/jxn tables are a host feature: with -i/-r the mode
        # runs as the single-worker equivalent, the degree sort on the
        # card, then the host parameterized insert (the reference's
        # one-rank run with the same options)
        from ..core.jxn import build_forest_jxn
        from ..ops.sort import degree_sequence_device
        if not use_mesh_sort and sequence_filename:
            seq = read_sequence(sequence_filename)
        else:
            seq = degree_sequence_device(edges.tail, edges.head,
                                         device=device)
        _finish_sort(seq, use_mesh_sort, sequence_filename, clock,
                     leader=is_leader, writer=proc0)
        jopts = _make_jopts(make_kids, make_pst, make_jxn, memory_limit,
                            width_limit, find_max_width)
        forest, seq, widths = build_forest_jxn(
            edges.tail, edges.head, seq, jopts)
        if is_leader:
            print_phase("Mapped", clock.phase_seconds())
            if use_mesh_reduce:
                print_phase("Reduced", clock.phase_seconds())
    elif use_mesh:
        from ..ops.sort import degree_sequence_device
        from ..parallel.build import (build_graph_distributed,
                                      map_graph_distributed)
        from ..parallel.mesh import mesh_size, process_count
        count = mesh_size(device)
        # SHEEP_WORKERS fixes the logical worker count; the mesh is capped
        # by the devices, and the merged result is the same for any size
        workers = int(os.environ.get("SHEEP_WORKERS") or 0) or count
        mesh_workers = min(workers, count)
        multi = process_count() > 1
        if multi:
            # a multi-process mesh spans every process's devices
            mesh_workers = count
        given_seq = None
        if not use_mesh_sort and sequence_filename:
            given_seq = read_sequence(sequence_filename)
        # -i without -r: save exactly `workers` partial trees for the
        # file-path merge (%02dr0.tre names).  A worker count that fits
        # the mesh builds them on the devices; more workers than devices
        # (or, across processes, any count but the whole mesh) build
        # partial_range slices on the host, as the reference does
        map_only = (use_mesh_sort and not use_mesh_reduce
                    and output_filename != "" and partitions == 0)
        if map_only:
            if given_seq is not None:
                seq = given_seq
            else:
                seq = degree_sequence_device(edges.tail, edges.head,
                                             device=device)
            _finish_sort(seq, use_mesh_sort, sequence_filename, clock,
                         leader=is_leader, writer=proc0)
            max_vid = edges.max_vid
            mesh_ok = not multi or workers == count
            if workers <= count and len(edges.tail) and mesh_ok:
                _, partials = map_graph_distributed(
                    edges.tail, edges.head, num_workers=workers,
                    seq=seq, device=device)
                if proc0:
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
                    if proc0:
                        write_tree(f"{output_filename}{w:02d}r0.tre",
                                   f.parent, f.pst_weight, sig=sig)
                    if forest is None:
                        forest = f
                        a0, b0 = a, b
                    if not proc0:
                        # another process: no collectives here and no
                        # writes, only worker 0's view for -f/-t/-c
                        break
            edges = EdgeList(edges.tail[a0:b0], edges.head[a0:b0],
                             file_edges=edges.file_edges, start=a0)
        elif rt_cfg is not None:
            from ..runtime.driver import build_graph_resilient
            seq, forest = build_graph_resilient(
                edges.tail, edges.head, num_workers=mesh_workers,
                seq=given_seq, max_vid=edges.max_vid, config=rt_cfg,
                device=device)
            _finish_sort(seq, use_mesh_sort, sequence_filename, clock,
                         leader=is_leader, writer=proc0)
        else:
            seq, forest = build_graph_distributed(
                edges.tail, edges.head, num_workers=mesh_workers,
                seq=given_seq, device=device)
            _finish_sort(seq, use_mesh_sort, sequence_filename, clock,
                         leader=is_leader, writer=proc0)
        if is_leader:
            print_phase("Mapped", clock.phase_seconds())
            if use_mesh_reduce:
                print_phase("Reduced", clock.phase_seconds())
    elif use_ext:
        # the out-of-core serial path: two streamed passes, no torch, no
        # in-RAM edge list; the serial path's phase grammar
        from ..ops.extmem import (build_forest_extmem,
                                  streaming_degree_sequence)
        ext_kw: dict = {}
        if rt_cfg is not None:
            ext_kw = dict(checkpoint_dir=rt_cfg.checkpoint_dir,
                          resume=rt_cfg.resume,
                          max_retries=rt_cfg.max_retries,
                          backoff_base_s=rt_cfg.backoff_base_s,
                          checkpoint_every=rt_cfg.checkpoint_every,
                          integrity=rt_cfg.integrity,
                          governor=rt_cfg.governor)
        if sequence_filename:
            seq = read_sequence(sequence_filename)
        else:
            seq, _, _ = streaming_degree_sequence(graph_filename)
        if is_leader:
            print_phase("Sorted", clock.phase_seconds())
        seq, forest = build_forest_extmem(graph_filename, seq=seq, **ext_kw)
        if is_leader:
            print_phase("Mapped", clock.phase_seconds())
    else:
        if sequence_filename:
            seq = read_sequence(sequence_filename)
        else:
            seq = degree_sequence(edges.tail, edges.head)
        if is_leader:
            print_phase("Sorted", clock.phase_seconds())
        if jxn_mode:
            from ..core.jxn import build_forest_jxn
            jopts = _make_jopts(make_kids, make_pst, make_jxn, memory_limit,
                                width_limit, find_max_width)
            forest, seq, widths = build_forest_jxn(
                edges.tail, edges.head, seq, jopts)
        elif rt_cfg is not None:
            # the serial path with fault tolerance: the single-chip chunk
            # loop under checkpoint/retry, degrading to the host oracle
            from ..runtime.driver import build_graph_resilient
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

    # under --ext the records never loaded; every vid with a record has
    # nonzero degree and is therefore in the sequence, so seq.max() IS
    # the file's max vid
    max_vid = edges.max_vid if edges is not None else \
        (int(np.asarray(seq).max()) if len(seq) else 0)
    if partitions != 0:
        p = Partition.from_forest(seq, forest, partitions, max_vid=max_vid)
        if output_filename:
            if proc0:
                prefix = output_filename + \
                    ("-w0000-p" if use_mesh_reduce else "")
                p.write_partitioned_graph(edges.tail, edges.head, seq,
                                          prefix, max_vid=max_vid)
        elif is_leader:
            p.print()
    elif output_filename and not map_only and proc0:
        write_tree(output_filename, forest.parent, forest.pst_weight,
                   sig=_tree_sig(seq))

    # diagnostics print from process 0 only in a multi-process job
    if verbose and proc0:
        print_phase("Built", clock.total_seconds())
    if do_faqs and proc0:
        compute_facts(forest, widths=widths).print()
    if do_print and proc0:
        print_tree(seq, forest.parent, forest.pst_weight)
    if do_validate and proc0:
        if edges is None:
            print("warning: -c needs the in-RAM edge list; skipped under "
                  "the external-memory build", file=sys.stderr)
        elif is_valid_forest(forest, edges.tail, edges.head, seq,
                             max_vid=edges.max_vid):
            print("Tree is valid.")
        else:
            print("ERROR: Tree is not valid.")
    if verbose and proc0:
        print_phase("Finished", clock.total_seconds())
    return 0


if __name__ == "__main__":
    sys.exit(main())
