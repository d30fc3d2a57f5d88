"""The command-line tools (port of sheep_tpu/cli), each run as
``python -m sheep_tpu_torch.cli.<tool>``:

  graph2tree       load a graph, sort, build the elimination forest
                   (serial on the host; --ext streamed from the .dat;
                   --distext the supervised job of record-slice legs;
                   -k -e -j -w -x the treewidth mode; -i/-r on the card
                   through K1), partition or write it
  degree_sequence  the streamed degree sort of an edge file
  make_graph       a seeded R-MAT graph as a .dat file
  partition_tree   partition a .tre, print, evaluate or write it
  merge_trees      the associative merge of partial trees
  fsck             verify artifacts and their sidecars
  plan             resolve and explain a build's plan; harvest priors
  supervise        the chaos-hardened sort -> map -> merge tournament,
                   each leg a process of its own; --status reports it
  distext          one leg of the distributed out-of-core build (hist
                   or map over a record slice), as the supervisor
                   dispatches it

Each keeps the reference's flags, usage strings, phase lines, exit codes
and output bytes.  ``main(argv, device=...)`` takes the device of the
routes that run on the card; None means CUDA, and no flag or environment
variable picks the CPU.  Only those routes load torch.
"""
