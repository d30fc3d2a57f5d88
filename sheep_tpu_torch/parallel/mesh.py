"""The worker mesh of the distributed build (port of
sheep_tpu/parallel/mesh.py).

The reference's distribution unit is a mesh axis ``'workers'`` over which
edge records are sharded: the degree histogram is summed across it (the
MPI_Allreduce of lib/sequence.h:78), the chunked reduce takes the
minimum of the per-worker jump tables across it each round, and the
partial forests merge with an all-gather and an associative rebuild (the
MPI_Reduce custom op of lib/jnode.cpp:203-250).  JAX runs that as one
SPMD program under ``shard_map``; PyTorch has no counterpart, so the
port's :class:`Mesh` is a list of this process's worker devices plus,
after :func:`init_distributed`, a ``torch.distributed`` process group.

The mesh's workers are those of every process in rank order (each
process holds the same number), as ``jax.devices()`` spans every process
after ``jax.distributed.initialize``.  Per-worker state is a list of
tensors, one per local worker on that worker's device; a replicated
value is one tensor on the process's first worker device.  The four
collectives the reference uses (``psum``, ``pmin``, ``pmax``,
``all_gather``) are methods: each combines the local workers' tensors
with tensor ops on one device, then across processes runs
``dist.all_reduce`` or ``dist.all_gather_into_tensor`` on the result.
The backend follows the device: NCCL on CUDA, gloo on the CPU.

:func:`mesh_devices` is the counterpart of ``jax.devices()`` for one
process: every CUDA card, or the one CPU.  Tests and ``chip_smoke.py``
replace it with a repeated device (``[cpu] * W``, ``[cuda:0] * W``), as
the reference's tests force eight virtual CPU devices; no environment
variable or argument adds virtual workers for users.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

from .. import resolve_device

AXIS = "workers"


def mesh_devices(device) -> list[torch.device]:
    """This process's worker devices for a build on ``device``: every
    CUDA card (``cuda:0`` … ``cuda:k-1``) on CUDA, the CPU on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def process_count() -> int:
    """The processes of the job: 1 until :func:`init_distributed`."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_size(device) -> int:
    """The workers a mesh on ``device`` can span: this process's devices
    times the processes of the job."""
    return len(mesh_devices(device)) * process_count()


class Mesh:
    """Ordered workers over the devices of every process of the job.

    ``devices``: this process's workers; ``size``: the workers of the
    job; ``offset``: the mesh index of this process's first worker;
    ``home``: the device that holds replicated values.  ``grouped``: the
    collectives go through the process group (after
    :func:`init_distributed`, at any world size, one included).
    ``k1_launches`` counts the K1 launches of each local worker's sharded
    rounds (read from ``ops.fused_jump.launches`` around them)."""

    def __init__(self, devices: list, grouped: bool = False):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one worker")
        self.grouped = grouped
        self.world = dist.get_world_size() if grouped else 1
        self.rank = dist.get_rank() if grouped else 0
        self.local = len(self.devices)
        self.size = self.local * self.world
        self.offset = self.rank * self.local
        self.home = self.devices[0]
        self.k1_launches = [0] * self.local
        if grouped:
            backend = dist.get_backend()
            want = "nccl" if self.home.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(
                    f"a mesh on {self.home.type} needs the {want} backend, "
                    f"the process group has {backend}")

    # -- staging ---------------------------------------------------------

    def scatter(self, x) -> list:
        """The replicated tensor ``x`` on every local worker's device (one
        tensor shared by the workers of one device)."""
        return [x.to(d) for d in self.devices]

    def rows(self, full) -> list:
        """This process's rows of a host array of one row per mesh worker
        (``full`` [size, ...] numpy): every process holds the whole array
        and contributes its rows, as the reference's
        ``make_array_from_callback`` staging does."""
        if len(full) != self.size:
            raise ValueError(f"{len(full)} rows for a mesh of {self.size}")
        return [torch.from_numpy(full[self.offset + i].copy()).to(d)
                for i, d in enumerate(self.devices)]

    def replicate(self, x) -> torch.Tensor:
        """A host array as the mesh's replicated tensor (on ``home``)."""
        return torch.from_numpy(x.copy()).to(self.home)

    # -- collectives -----------------------------------------------------

    def _combine(self, xs: list, local_op, op) -> torch.Tensor:
        acc = xs[0].to(self.home)
        for x in xs[1:]:
            acc = local_op(acc, x.to(self.home))
        if self.grouped:
            if acc is xs[0]:
                acc = acc.clone()  # all_reduce writes in place
            dist.all_reduce(acc, op=op)
        return acc

    def psum(self, xs: list) -> torch.Tensor:
        """Sum over the mesh's workers of the local tensors ``xs`` (one a
        worker); replicated on ``home``."""
        return self._combine(xs, torch.add, dist.ReduceOp.SUM)

    def pmin(self, xs: list) -> torch.Tensor:
        return self._combine(xs, torch.minimum, dist.ReduceOp.MIN)

    def pmax(self, xs: list) -> torch.Tensor:
        return self._combine(xs, torch.maximum, dist.ReduceOp.MAX)

    def all_gather(self, xs: list) -> torch.Tensor:
        """The workers' tensors stacked in mesh order, [size, ...],
        replicated on ``home``."""
        local = torch.stack([x.to(self.home) for x in xs])
        if not self.grouped:
            return local
        out = torch.empty((self.size,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=self.home)
        dist.all_gather_into_tensor(out, local.contiguous())
        return out


def make_mesh(num_workers: int | None = None, device=None) -> Mesh:
    """A mesh of ``num_workers`` workers (all of them when None) for a
    build on ``device`` (None is CUDA).  Raises when more workers are
    asked for than the devices hold; a multi-process mesh spans every
    process's devices, as the reference's CLI makes it."""
    device = resolve_device(device)
    devices = mesh_devices(device)
    world = process_count()
    total = len(devices) * world
    if num_workers is None:
        num_workers = total
    if num_workers > total:
        raise ValueError(
            f"requested {num_workers} workers but only {total} devices")
    if world > 1:
        if num_workers != total:
            raise ValueError(
                f"a mesh across {world} processes spans all {total} "
                f"workers, not {num_workers}")
        return Mesh(devices, grouped=True)
    return Mesh(devices[:num_workers], grouped=dist.is_initialized())


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     connect_timeout_s: float | None = None,
                     device=None) -> None:
    """Join a multi-process job (the reference's ``mpiexec`` across nodes):
    ``dist.init_process_group`` over ``tcp://{coordinator_address}`` with
    this world size and rank, NCCL for a build on CUDA and gloo on the
    CPU (``device`` None is CUDA).  Process 0 hosts the rendezvous.  With
    no address, torch's launcher environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) is read instead.  Each process's workers are its
    :func:`mesh_devices` (set ``CUDA_VISIBLE_DEVICES`` per process to
    give each its own cards).

    ``connect_timeout_s`` bounds the wait for the coordinator (default:
    SHEEP_CONNECT_TIMEOUT, else 300 s).  An unreachable coordinator raises
    a RuntimeError naming the address instead of hanging the process."""
    device = resolve_device(device)
    if connect_timeout_s is None:
        connect_timeout_s = float(os.environ.get("SHEEP_CONNECT_TIMEOUT",
                                                 "300"))
    if coordinator_address and process_id not in (None, 0):
        # other ranks probe first: the coordinator may come up after its
        # workers, and a clear error beats a hang inside the store client
        _probe_coordinator(coordinator_address, connect_timeout_s,
                           process_id, num_processes)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(mesh_devices(device)[0])
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=connect_timeout_s))
    if coordinator_address:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    else:
        kw.update(init_method="env://")
    try:
        dist.init_process_group(**kw)
    except Exception as exc:
        addr = coordinator_address or "env://"
        raise RuntimeError(
            f"could not join the torch.distributed coordinator at {addr} "
            f"(process {process_id}/{num_processes}, waited up to "
            f"{connect_timeout_s:.0f}s): {exc}") from exc


def _probe_coordinator(address: str, timeout_s: float,
                       process_id, num_processes) -> None:
    """Retry a plain TCP connect to ``address`` until it accepts or
    ``timeout_s`` elapses; raise a RuntimeError naming the address on
    failure.  Launchers start every rank at once, so the coordinator may
    come up after its workers: hence the retry loop."""
    host, _, port_s = address.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        raise RuntimeError(
            f"malformed coordinator address {address!r} "
            "(want host:port)") from None
    deadline = time.monotonic() + timeout_s
    last: Exception | None = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise RuntimeError(
                f"could not join the torch.distributed coordinator at "
                f"{address} (process {process_id}/{num_processes}, waited "
                f"up to {timeout_s:.0f}s): {last}") from last
        try:
            with socket.create_connection((host or "127.0.0.1", port),
                                          timeout=min(5.0, remaining)):
                return
        except OSError as exc:
            last = exc
            time.sleep(min(0.2, max(0.0, deadline - time.monotonic())))


def edge_sharding(mesh: Mesh, full) -> list:
    """The counterpart of the reference's ``edge_sharding``: a host array
    of one row per mesh worker as this process's per-worker tensors."""
    return mesh.rows(full)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The counterpart of the reference's ``replicated``: a host array as
    the mesh's replicated tensor."""
    return mesh.replicate(x)
