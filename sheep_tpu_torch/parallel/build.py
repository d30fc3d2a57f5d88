"""The mesh-sharded distributed build: the `-i -r` path (port of
sheep_tpu/parallel/build.py).

Reference semantics being reproduced:

  - ``-i`` mpiSequence (lib/sequence.h:65-93): per-shard degree
    histogram, a sum across the mesh, then the identical sort.
  - map (the per-rank insert loop of lib/jtree.cpp): the forest fixpoint
    on each worker's edge shard.
  - ``-r`` mpi_merge (lib/jnode.cpp:203-250): the merge is associative
    over same-sequence partials, so one all-gather of the per-worker
    (kid, parent) links and one fixpoint rebuild equal any reduction
    order.  pst is a plain sum.

Edges are padded to a multiple of the worker count with (n, n) phantom
records: the phantom vid takes histogram slot n, which is sliced away,
and its links map to the sentinel, so padding cannot change a result.

Where the reference runs one SPMD program under ``shard_map``, the port
runs the per-worker part once for each worker of its :class:`Mesh`, and
the collectives are the mesh's methods.  A replicated computation (the
degree sort after the histogram sum, the merge fixpoint) runs once per
process on the mesh's ``home`` device.  On CUDA every fixpoint round
descends through kernel K1.

``build_graph_distributed`` routes a mesh of one worker through the
hybrid build (``ops.build.build_graph_hybrid``) behind the fast forest
self-check, and a larger mesh through the chunked build
(``parallel.chunked``; ``SHEEP_MESH_KERNEL=loop`` selects the
single-dispatch twin, :func:`distributed_build_step`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..core.forest import Forest
from ..core.validate import check_forest_fast
from ..integrity.errors import IntegrityError
from ..ops.forest import forest_fixpoint, pst_weights
from ..ops.sort import degree_order
from .mesh import Mesh, make_mesh


def _links_from_positions(pt, ph, n: int):
    """Shared per-shard link mapping: position pairs -> (lo, hi,
    pst_local).  Every edge whose earlier endpoint is present counts
    toward pst, edges to absent vids (position >= n) included
    (jtree.cpp:47-49); only self-loops, padding and both-absent pairs (lo
    == hi) are left out.  lo/hi come back sentinel-masked for the
    fixpoint, which must see only fully present links."""
    lo = torch.minimum(pt, ph)
    hi = torch.maximum(pt, ph)
    pst_local = pst_weights(torch.where(lo == hi, n, lo), n)
    dead = (lo >= hi) | (hi >= n)
    return torch.where(dead, n, lo), torch.where(dead, n, hi), pst_local


def _gather_merge(parent_local: list, n: int, mesh: Mesh):
    """All-gather the per-worker partial forests and rebuild them
    associatively (the reference's MPI_Reduce custom op,
    lib/jnode.cpp:203-250).  Returns (parent, rounds), replicated: the
    rebuild runs once per process."""
    parents = mesh.all_gather(parent_local)  # [W, n]
    kid = torch.arange(n, dtype=torch.int32,
                       device=parents.device).expand_as(parents)
    live = parents < n
    mlo = torch.where(live, kid, n).to(torch.int32).reshape(-1)
    mhi = torch.where(live, parents, n).to(torch.int32).reshape(-1)
    return forest_fixpoint(mlo, mhi, n)


def _given_order(posr: torch.Tensor, n: int):
    """(seq, pos, m) from a given replicated vid -> position table:
    INVALID slots (-1 after the int32 view) and positions >= n are
    absent."""
    posi = posr.to(torch.int32)
    absent = (posi < 0) | (posi >= n)
    pos = torch.where(absent, n, posi).to(torch.int32)
    # jnp's mode="drop": absent vids scatter into a trash slot
    seq = torch.full((n + 1,), n, dtype=torch.int32, device=posi.device)
    seq[torch.where(absent, n, pos).long()] = torch.arange(
        n, dtype=torch.int32, device=posi.device)
    m = n - absent.sum(dtype=torch.int32)
    return seq[:n], pos, m


def _degree_order_sharded(tail: list, head: list, n: int, mesh: Mesh):
    """The distributed degree sort: per-worker histograms (slot n takes
    the padding), summed across the mesh, then one sort."""
    degs = []
    for t, h in zip(tail, head):
        deg = torch.zeros(n + 1, dtype=torch.int32, device=t.device)
        deg.index_add_(0, t, torch.ones_like(t))
        deg.index_add_(0, h, torch.ones_like(h))
        degs.append(deg)
    return degree_order(mesh.psum(degs)[:n])


def _sharded_build(tail: list, head: list, given_pos, n: int, mesh: Mesh,
                   do_merge: bool = True):
    """The single-dispatch twin's body over the mesh's workers.

    ``given_pos``: None runs the degree sort; otherwise a replicated vid
    -> position table is used as it is (`-r` without `-i`).
    ``do_merge``: False skips the reduce and returns the per-worker
    partials stacked [W, n] (`-i` without `-r`)."""
    from ..ops import fused_jump

    tail = [t.to(torch.int32) for t in tail]
    head = [h.to(torch.int32) for h in head]
    if given_pos is None:
        seq, pos, m = _degree_order_sharded(tail, head, n, mesh)
    else:
        seq, pos, m = _given_order(given_pos, n)
    pos_ext = torch.cat([pos, torch.full((1,), n, dtype=torch.int32,
                                         device=pos.device)])
    parent_local, pst_local, map_rounds = [], [], []
    for i, (pos_w, t, h) in enumerate(zip(mesh.scatter(pos_ext), tail,
                                          head)):
        lo, hi, pst = _links_from_positions(
            torch.index_select(pos_w, 0, t), torch.index_select(pos_w, 0, h),
            n)
        before = fused_jump.launches
        parent, rounds = forest_fixpoint(lo, hi, n)
        mesh.k1_launches[i] += fused_jump.launches - before
        parent_local.append(parent)
        pst_local.append(pst)
        map_rounds.append(torch.tensor(rounds, dtype=torch.int32,
                                       device=t.device))
    if not do_merge:
        return (seq, pos, m, mesh.all_gather(parent_local),
                mesh.all_gather(pst_local), int(mesh.pmax(map_rounds)))
    parent, rounds = _gather_merge(parent_local, n, mesh)
    return seq, pos, m, parent, mesh.psum(pst_local), rounds


def distributed_build_step(tail: list, head: list, n: int, mesh: Mesh,
                           pos: torch.Tensor | None = None,
                           with_pos: bool = False, do_merge: bool = True):
    """The single-dispatch build over ``mesh``: edge shards in (this
    process's per-worker tensors of equal length, padded with n),
    replicated forest out.  Returns (seq, pos, num_active, parent, pst,
    merge_rounds); ``parent[v] == n`` marks roots, in full n-slot position
    space.  With ``do_merge=False`` parent/pst come back stacked [W, n]
    (the per-worker partials).  ``with_pos`` uses the given replicated
    vid -> position table ``pos`` instead of the degree sort."""
    return _sharded_build(tail, head, pos if with_pos else None, n, mesh,
                          do_merge=do_merge)


def _pad_edges(tail, head, n: int, w: int):
    """Records padded with n to a multiple of w (at least one a worker),
    as [w, e_pad / w] rows: worker i's shard is the i-th contiguous
    slice."""
    e = len(tail)
    e_pad = max(w, ((e + w - 1) // w) * w)
    t = np.full(e_pad, n, dtype=np.int64)
    h = np.full(e_pad, n, dtype=np.int64)
    t[:e] = tail
    h[:e] = head
    return (t.astype(np.int32).reshape(w, -1),
            h.astype(np.int32).reshape(w, -1))


def _fetch(x) -> np.ndarray:
    """A replicated tensor (or a number) -> host numpy; every process
    holds its own copy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _to_forest(parent, pst, n: int, m: int) -> Forest:
    """Trim to the m active slots, then the ops converter.  n=m is sound:
    live parents of active nodes are active positions (< m), and the root
    sentinel n and any padding slot are >= m, so they map to INVALID
    either way."""
    from ..ops.forest import _to_forest as ops_to_forest
    return ops_to_forest(_fetch(parent)[:m], _fetch(pst)[:m], m)


def _mesh_kernel() -> str:
    """The multi-worker kernel (SHEEP_MESH_KERNEL): "chunked" (default,
    bounded dispatches) or "loop" (the single-dispatch fixpoint twin).
    Anything else is an error: a typo must not silently select the other
    kernel."""
    kernel = os.environ.get("SHEEP_MESH_KERNEL", "chunked")
    if kernel not in ("chunked", "loop"):
        raise ValueError(
            f"SHEEP_MESH_KERNEL={kernel!r} must be 'chunked' or 'loop'")
    return kernel


def _num_vertices(tail, head, num_vertices, seq) -> int:
    n = num_vertices
    if n is None:
        n = int(max(tail.max(initial=0), head.max(initial=0))) + 1 \
            if len(tail) else 0
    if seq is not None and len(seq):
        n = max(n, int(np.asarray(seq).max()) + 1)
    return n


def _run_distributed(tail, head, num_vertices, num_workers, seq, do_merge,
                     mesh=None, device=None):
    """Shared prologue and dispatch of the host-facing wrappers on the
    loop kernel.  Returns (out_seq, parent, pst, n, m, mesh_size), parent
    and pst merged [n] or stacked [W, n] as ``do_merge`` says; n == 0
    is the empty graph."""
    if mesh is None:
        mesh = make_mesh(num_workers, device)
    n = _num_vertices(tail, head, num_vertices, seq)
    if n == 0:
        return np.empty(0, np.uint32), None, None, 0, 0, mesh.size
    if mesh.size == 1:
        # a mesh of one is a whole-graph build: the hosted loop, the
        # same result
        return _single_worker_build(tail, head, n, seq, do_merge, mesh.home)
    t_np, h_np = _pad_edges(tail, head, n, mesh.size)
    # every process holds the full arrays (the reference's shared-
    # filesystem load) and stages its own rows
    t, h = mesh.rows(t_np), mesh.rows(h_np)
    if seq is None:
        dseq, _, m, parent, pst, _ = distributed_build_step(
            t, h, n, mesh, do_merge=do_merge)
        m = int(m)
        out_seq = _fetch(dseq)[:m].astype(np.uint32)
    else:
        from ..core.sequence import sequence_positions
        pos = sequence_positions(seq, n - 1).astype(np.int64)
        pos = mesh.replicate(pos.astype(np.int32))
        _, _, m, parent, pst, _ = distributed_build_step(
            t, h, n, mesh, pos=pos, with_pos=True, do_merge=do_merge)
        m = len(seq)
        out_seq = np.asarray(seq, dtype=np.uint32)
    return out_seq, _fetch(parent), _fetch(pst), n, m, mesh.size


def _single_worker_build(tail, head, n: int, seq, do_merge: bool,
                         device: torch.device):
    """The mesh-of-one case through the hosted loop (the same output
    contract as :func:`_run_distributed`)."""
    from ..ops.build import prepare_links
    from ..ops.forest import forest_fixpoint_hosted
    from ..ops.sort import given_seq_links

    t = torch.from_numpy(np.asarray(tail).astype(np.int32)).to(device)
    h = torch.from_numpy(np.asarray(head).astype(np.int32)).to(device)
    if seq is None:
        dseq, _, m, lo, hi, pst = prepare_links(t, h, n)
        m = int(m)
        out_seq = _fetch(dseq)[:m].astype(np.uint32)
    else:
        lo, hi, pst = given_seq_links(t, h, seq, n)
        m = len(seq)
        out_seq = np.asarray(seq, dtype=np.uint32)
    parent, _ = forest_fixpoint_hosted(lo, hi, n)
    parent, pst = _fetch(parent), _fetch(pst)
    if not do_merge:
        parent, pst = parent[None, :], pst[None, :]
    return out_seq, parent, pst, n, m, 1


def _selfcheck_forest(seq, forest, what: str):
    """Run the vectorised fast oracle (core.validate.check_forest_fast)
    on the forest this path hands downstream: O(n) numpy on the host,
    and it turns a wrong answer from a sick card into a typed
    IntegrityError where it happened.  SHEEP_SELFCHECK=0 opts out."""
    if os.environ.get("SHEEP_SELFCHECK", "1") == "0":
        return seq, forest
    problems = check_forest_fast(forest)
    if problems:
        raise IntegrityError(
            f"{what} produced an invalid forest: " + "; ".join(problems))
    return seq, forest


def build_graph_distributed(tail: np.ndarray, head: np.ndarray,
                            num_vertices: int | None = None,
                            num_workers: int | None = None,
                            seq: np.ndarray | None = None, device=None,
                            timings: dict | None = None,
                            comm: dict | None = None):
    """Host-facing distributed build: (seq uint32 [m], Forest over m).

    ``seq``: a given elimination order (`-r` without `-i`); None runs the
    degree sort.  ``device`` None is CUDA (RuntimeError without it).
    SHEEP_CHECKPOINT_DIR reroutes through the fault-tolerant runtime
    (``runtime.build_graph_resilient``: checkpoint/resume, retry, the
    mesh -> single -> host ladder), bit-identical.  A mesh of one worker
    is ``ops.build.build_graph_hybrid``; a larger one the chunked mesh
    build (``parallel.chunked``), which fills ``timings`` and ``comm``
    (see ``build_links_chunked_sharded``), or with SHEEP_MESH_KERNEL=loop
    the single-dispatch twin.  Every result passes the forest
    self-check."""
    device = resolve_device(device)
    if os.environ.get("SHEEP_CHECKPOINT_DIR"):
        from ..runtime.driver import build_graph_resilient
        return build_graph_resilient(tail, head, num_vertices=num_vertices,
                                     num_workers=num_workers, seq=seq,
                                     device=device)
    mesh = make_mesh(num_workers, device)
    if mesh.size == 1 and len(tail):
        from ..ops.build import build_graph_hybrid
        return _selfcheck_forest(
            *build_graph_hybrid(tail, head, num_vertices=num_vertices,
                                seq=seq, device=device),
            what="hybrid build")
    if _mesh_kernel() == "chunked":
        from .chunked import build_graph_chunked_distributed
        return _selfcheck_forest(
            *build_graph_chunked_distributed(
                tail, head, num_vertices=num_vertices,
                num_workers=num_workers, seq=seq, device=device,
                timings=timings, comm=comm),
            what="chunked mesh build")
    out_seq, parent, pst, n, m, _ = _run_distributed(
        tail, head, num_vertices, num_workers, seq, do_merge=True,
        mesh=mesh)
    if n == 0:
        return out_seq, Forest(np.empty(0, np.uint32),
                               np.empty(0, np.uint32))
    return _selfcheck_forest(out_seq, _to_forest(parent, pst, n, m),
                             what="mesh build")


def map_graph_distributed(tail: np.ndarray, head: np.ndarray,
                          num_vertices: int | None = None,
                          num_workers: int | None = None,
                          seq: np.ndarray | None = None, device=None):
    """Map-only (`-i` without `-r`): per-worker partial forests, no
    merge.  Returns (seq uint32 [m], [Forest over m] * W): each partial
    covers the full vertex set over the shared sequence, ready for the
    file-path merge (the reference's graph2tree.cpp:148,158 rank-suffixed
    saves).  ``device`` None is CUDA."""
    device = resolve_device(device)
    if _mesh_kernel() == "chunked":
        from .chunked import map_graph_chunked_distributed
        return map_graph_chunked_distributed(
            tail, head, num_vertices=num_vertices,
            num_workers=num_workers, seq=seq, device=device)
    out_seq, parents, psts, n, m, w = _run_distributed(
        tail, head, num_vertices, num_workers, seq, do_merge=False,
        device=device)
    if n == 0:
        return out_seq, []
    return out_seq, [_to_forest(parents[i], psts[i], n, m)
                     for i in range(w)]
