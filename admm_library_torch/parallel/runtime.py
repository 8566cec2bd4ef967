"""SPMD runtime on torch.distributed: process bootstrap, the (data,
horizon) mesh, and the collectives of the partitioned drivers.

Every rank runs the same host program on its slice of the problem;
NCCL carries the collectives between GPUs, gloo between CPU processes
(the tests). Canonical axes:

    'data'     — scenario batch; only the loop predicate and the
                 shared-rho statistics cross it.
    'horizon'  — time-partitioned consensus blocks; a neighbour exchange
                 per iteration and scalar max reductions per check.

An axis of size 1 has no process group and its collectives are the
identity: they make no `torch.distributed` call, so one process on one
card needs no `init_process_group`.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
HORIZON_AXIS = "horizon"


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None) -> None:
    """Join the process group. No-op in a single process.

    Arguments default from the standard torch.distributed environment
    (WORLD_SIZE, RANK, MASTER_ADDR/MASTER_PORT, as torchrun sets them);
    the backend defaults to NCCL where CUDA is available, else gloo.
    Safe to call unconditionally at program start on every rank.
    """
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return                              # single-process run
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (data, horizon) mesh: the axis sizes, its
    coordinate on each axis, the process group of each axis (None for an
    axis of size 1), the global ranks of that group by coordinate, the
    world size and the rank's device."""

    shape: dict
    coords: dict
    groups: dict
    ranks: dict
    world: int
    device: torch.device


def make_mesh(data: int | None = None, horizon: int = 1,
              device=None) -> Mesh:
    """2-D (data, horizon) mesh over every rank of the process group
    (one rank when none is initialised).

    `data` defaults to world_size // horizon. The horizon axis is
    innermost, rank = d * horizon + h, so consensus neighbours are
    adjacent ranks. Every rank must call this with the same arguments:
    each builds every group of each axis, in the same order, and keeps
    its own. The device is `device`, or cuda:<local rank> (LOCAL_RANK,
    else the rank modulo the card count).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if world % horizon:
            raise ValueError(f"{world} ranks not divisible by "
                             f"horizon={horizon}")
        data = world // horizon
    if data * horizon != world:
        raise ValueError(f"mesh {data}x{horizon} != {world} ranks")
    d, h = divmod(rank, horizon)
    members = {
        DATA_AXIS: [[dd * horizon + hh for dd in range(data)]
                    for hh in range(horizon)],
        HORIZON_AXIS: [[dd * horizon + hh for hh in range(horizon)]
                       for dd in range(data)],
    }
    groups, ranks = {}, {}
    for axis in (DATA_AXIS, HORIZON_AXIS):
        groups[axis] = None
        ranks[axis] = tuple(members[axis][h if axis == DATA_AXIS else d])
        if len(ranks[axis]) > 1:
            for rs in members[axis]:
                g = dist.new_group(rs)
                if rank in rs:
                    groups[axis] = g
    if device is None:
        local = int(os.environ.get(
            "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
    return Mesh(shape={DATA_AXIS: data, HORIZON_AXIS: horizon},
                coords={DATA_AXIS: d, HORIZON_AXIS: h}, groups=groups,
                ranks=ranks, world=world, device=torch.device(device))


def describe(mesh: Mesh | None = None) -> dict:
    """Topology snapshot for logs."""
    out = {
        "rank": dist.get_rank() if dist.is_initialized() else 0,
        "world_size": dist.get_world_size() if dist.is_initialized() else 1,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "cuda_devices": torch.cuda.device_count(),
    }
    if mesh is not None:
        out.update(mesh=dict(mesh.shape), coords=dict(mesh.coords),
                   device=str(mesh.device))
    return out


def _all_reduce(v, op, group):
    out = v.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def pmax(v, mesh: Mesh, axis: str):
    """Elementwise max of v over the ranks of `axis`."""
    g = mesh.groups[axis]
    return v if g is None else _all_reduce(v, dist.ReduceOp.MAX, g)


def psum(v, mesh: Mesh, axis: str):
    """Elementwise sum of v over the ranks of `axis`."""
    g = mesh.groups[axis]
    return v if g is None else _all_reduce(v, dist.ReduceOp.SUM, g)


def all_gather(v, mesh: Mesh, axis: str, dim: int = 0):
    """The slices of every rank of `axis`, concatenated along `dim` in
    coordinate order."""
    g = mesh.groups[axis]
    if g is None:
        return v
    v = v.contiguous()
    parts = [torch.empty_like(v) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, v, group=g)
    return torch.cat(parts, dim=dim)


def ring_shift(v, mesh: Mesh, axis: str, step: int):
    """Cyclic permutation along `axis`: every rank sends v to the rank
    `step` places after it and returns what the rank `step` places
    before it sent (the reference's `ppermute` with perm (i, i+step))."""
    size = mesh.shape[axis]
    g = mesh.groups[axis]
    if g is None or size == 1:
        return v
    i = mesh.coords[axis]
    peers = mesh.ranks[axis]
    send = v.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, peers[(i + step) % size], group=g),
        dist.P2POp(dist.irecv, recv, peers[(i - step) % size], group=g)])
    for r in reqs:
        r.wait()
    return recv


def agree(flags, mesh: Mesh):
    """Max of an integer flag tensor over every rank: the host reads it
    to take a branch (leave the loop, refactor), and every rank must take
    the same one or the next collective deadlocks."""
    if mesh.world == 1:
        return flags
    return _all_reduce(flags, dist.ReduceOp.MAX, None)
