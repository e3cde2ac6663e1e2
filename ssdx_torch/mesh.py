"""The parallelism layer: a process group plus this rank's device.

The port's counterpart of ``ssdx/mesh.py``.  The JAX package is one process
over many devices: a ``jax.sharding.Mesh`` with a ``data`` axis, and GSPMD
inserts the collectives.  PyTorch's idiom is one process per device with the
collectives written out through ``torch.distributed``, so the port's "mesh"
is a :class:`Mesh`: the process group, its ``size``, this process's ``rank``
and the device it computes on.  The semantics are the JAX package's: a global
batch split over N ranks computes what one device computes on the whole batch
(the same BatchNorm statistics, loss, update and detections), because

  * every rank holds the same parameters (broadcast from rank 0 once),
  * BatchNorm sums and the loss's positive count are all-reduced with
    :func:`all_reduce_sum`, which is differentiable: its backward all-reduces
    the cotangent, which is what ``jax.lax.psum`` transposes to,
  * the gradients are summed over ranks before the optimizer step.

``batch_sharding`` and ``replicated`` of the JAX module describe GSPMD
layouts and have no counterpart here: a rank's tensors are its shard, and
whatever every rank holds is replicated.

Backends: NCCL where every rank has a GPU of its own, gloo otherwise (CPU
runs; several ranks sharing one GPU, which NCCL refuses).  Gloo moves CUDA
tensors for ``all_reduce`` and ``broadcast`` only, so under gloo
:func:`all_gather_batch` stages CUDA tensors through the host and
:func:`barrier` reduces a host tensor.

With ``mesh=None``, or a mesh without a process group (one process that never
called :func:`initialize_distributed`), every collective is the identity and
makes no call.  A group of one rank does call its backend, so a single-GPU
run can exercise NCCL.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from . import resolve_device

__all__ = ["Mesh", "initialize_distributed", "finalize_distributed", "create_mesh",
           "shard_batch", "all_reduce_sum", "all_gather_batch", "broadcast_", "barrier"]


@dataclass(frozen=True)
class Mesh:
    """``group`` is None for a single process outside ``torch.distributed``."""

    group: Any
    size: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize_distributed(backend: str | None = None, init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None,
                           device=None) -> None:
    """Join the process group; a no-op for one process without arguments.

    Without arguments the launcher's environment decides (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
    them).  ``backend=None`` picks NCCL when the ranks of this host each have
    a CUDA device of their own and ``device`` is not the CPU, else gloo.
    """
    explicit = any(v is not None for v in (backend, init_method, world_size, rank))
    if dist.is_initialized() or (not explicit and _env_int("WORLD_SIZE", 1) == 1):
        return
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    rank = _env_int("RANK", 0) if rank is None else rank
    if backend is None:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        local = _env_int("LOCAL_WORLD_SIZE", world_size)
        backend = ("nccl" if not on_cpu and torch.cuda.is_available()
                   and torch.cuda.device_count() >= local else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK", rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def finalize_distributed() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def create_mesh(device=None) -> Mesh:
    """The data-parallel mesh over every rank of the process group (a mesh of
    one rank and no group when ``torch.distributed`` is not initialized).
    ``device=None`` is this rank's GPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(None, 1, 0, dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(), dev)


def _live(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def shard_batch(batch: Any, mesh: Mesh | None) -> Any:
    """This rank's slice of the leading axis of every leaf of ``batch`` (a
    tensor, an array, or a tuple / NamedTuple / list / dict of them).  The
    leading axis must divide evenly over the mesh."""
    if mesh is None or mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch(v, mesh) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} must divide evenly over {mesh.size} ranks")
    local = n // mesh.size
    return batch[mesh.rank * local:(mesh.rank + 1) * local]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank; differentiable (the
    backward all-reduces the cotangent)."""
    if not _live(mesh):
        return t
    return _AllReduceSum.apply(t, mesh.group)


def all_gather_batch(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the leading axis in rank order;
    shapes must agree across ranks.  Not differentiable."""
    if not _live(mesh):
        return t
    if t.dtype == torch.bool:  # not every backend moves bool
        return all_gather_batch(t.to(torch.uint8), mesh).bool()
    t = t.detach().contiguous()
    gloo = mesh.backend == "gloo"
    src = t.cpu() if gloo else t  # gloo gathers host tensors only
    out = torch.empty((mesh.size * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    if gloo:
        dist.all_gather(list(out.chunk(mesh.size)), src, group=mesh.group)
    else:
        dist.all_gather_into_tensor(out, src, group=mesh.group)
    return out.to(t.device)


def broadcast_(t: torch.Tensor, mesh: Mesh | None, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` in place with rank ``src``'s values."""
    if _live(mesh):
        dist.broadcast(t, src=src, group=mesh.group)
    return t


def barrier(mesh: Mesh | None) -> None:
    """Wait until every rank has arrived."""
    if not _live(mesh):
        return
    if mesh.backend == "gloo":  # a host tensor: gloo's barrier must not touch the GPU
        dist.all_reduce(torch.zeros(1), group=mesh.group)
    else:
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
