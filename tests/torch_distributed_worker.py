"""One process of a two-process CPU job for tests/test_torch_distributed.py.

    python tests/torch_distributed_worker.py COORD NPROC RANK OUTDIR

Joins the job through ``parallel.init_distributed`` (gloo, one CPU worker
a process), runs the port's mesh builds on a seeded graph, and writes
every result to ``OUTDIR/rank{RANK}.npz``: each process holds the same
replicated results.
"""

import json
import os
import sys

import numpy as np


def graph():
    rng = np.random.default_rng(2024)
    n, e = 300, 2000
    tail = rng.integers(0, n, e).astype(np.uint32)
    head = rng.integers(0, n, e).astype(np.uint32)
    tail[0] = n - 1
    return tail, head


def main() -> int:
    coord, nproc, rank, outdir = sys.argv[1:5]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    from sheep_tpu_torch.core.sequence import (degree_sequence,
                                               sequence_positions)
    from sheep_tpu_torch.parallel import (build_graph_distributed,
                                          build_graph_streaming_chunked,
                                          build_graph_streaming_sharded,
                                          init_distributed, make_mesh,
                                          map_graph_distributed)

    init_distributed(coord, int(nproc), int(rank), connect_timeout_s=60,
                     device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.size == int(nproc) and mesh.offset == int(rank), \
        (mesh.size, mesh.offset)
    out = {}
    # the collectives across the two processes
    import torch
    x = [torch.tensor([int(rank) + 1, 10 - int(rank)], dtype=torch.int32)]
    out["psum"] = mesh.psum(x).numpy()
    out["pmin"] = mesh.pmin(x).numpy()
    out["pmax"] = mesh.pmax(x).numpy()
    out["gather"] = mesh.all_gather(x).numpy()

    tail, head = graph()
    tm, comm = {}, {}
    seq, f = build_graph_distributed(tail, head, device="cpu", timings=tm,
                                     comm=comm)
    out.update(seq=seq, parent=f.parent, pst=f.pst_weight)
    out["timings"] = np.frombuffer(json.dumps(
        {k: tm[k] for k in ("map_rounds", "reduce_rounds")}).encode(),
        np.uint8)
    out["comm"] = np.frombuffer(json.dumps(comm).encode(), np.uint8)
    given = degree_sequence(tail, head)[:-5]
    _, f = build_graph_distributed(tail, head, seq=given, device="cpu")
    out.update(given_parent=f.parent, given_pst=f.pst_weight)
    _, parts = map_graph_distributed(tail, head, device="cpu")
    for i, p in enumerate(parts):
        out[f"map{i}_parent"] = p.parent
        out[f"map{i}_pst"] = p.pst_weight
    os.environ["SHEEP_MESH_KERNEL"] = "loop"
    _, f = build_graph_distributed(tail, head, device="cpu")
    out.update(loop_parent=f.parent, loop_pst=f.pst_weight)
    del os.environ["SHEEP_MESH_KERNEL"]
    seq = degree_sequence(tail, head)
    pos = sequence_positions(seq, int(max(tail.max(), head.max())))
    block = 700

    def blocks():
        return ((tail[a:a + block], head[a:a + block])
                for a in range(0, len(tail), block))

    f, rounds = build_graph_streaming_chunked(blocks(), len(seq), pos,
                                              block, device="cpu")
    out.update(schunk_parent=f.parent, schunk_pst=f.pst_weight,
               schunk_rounds=np.array(rounds))
    f, rounds = build_graph_streaming_sharded(blocks(), len(seq), pos,
                                              block, device="cpu")
    out.update(sshard_parent=f.parent, sshard_pst=f.pst_weight,
               sshard_rounds=np.array(rounds))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
