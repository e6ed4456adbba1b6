"""The world of a training run (counterpart of ``sddm_tpu/parallel/mesh.py``).

Where JAX has one process driving a mesh of local devices, the port has one
process per device, started by ``torchrun``: ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in the environment make :func:`init_world` start the process
group, NCCL with device ``cuda:LOCAL_RANK`` on the card and gloo under
``-d cpu``.  Without those variables there is no process group: the world is
this process alone and every helper here leaves the run as it was.

:class:`Mesh` is the grid of ranks, ``(data,)`` or ``(data, model)`` with
the model axis fastest (``parallel/tensor.py``), with its
``torch.distributed`` ``DeviceMesh``.  :func:`make_mesh` is the 1-D data
mesh over the world, :func:`replicate` broadcasts rank 0's parameters and
buffers, :func:`shard_batch` cuts this rank's rows out of a global batch,
:func:`gather_rows` puts it back together on every rank, :func:`global_mean`
averages a value over the data axis and :func:`all_finite` reduces a verdict
over the world.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched() -> bool:
    """Whether ``torchrun`` (or a launcher setting its variables) started
    this process."""
    return all(name in os.environ for name in ENV)


def init_world(device=None, backend: Optional[str] = None) -> torch.device:
    """Start the process group once, where the launcher asked for one, and
    return this rank's device.  ``device`` is the ``-d`` flag: ``cpu`` (gloo),
    or None / ``cuda`` for the card (NCCL, ``cuda:LOCAL_RANK``); ``backend``
    overrides the backend (gloo lets several ranks share one card).  Without
    the launcher's variables it is ``enhance.resolve_device(device)``."""
    from ..enhance import resolve_device

    if not launched():
        return resolve_device(device)
    local_rank = int(os.environ["LOCAL_RANK"])
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        dev = torch.device("cpu")
    else:
        resolve_device(device)  # no card and no -d cpu: the same refusal
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("gloo" if on_cpu else "nccl"))
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def finish_world() -> None:
    """Tear the process group down at a command's end."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shared_run_id() -> Optional[str]:
    """Rank 0's run id (its clock's ``%m%d_%H%M%S``), the same on every rank,
    so that all ranks name one run dir; None without a process group (the
    config parser then reads its own clock, as it always has)."""
    if not dist.is_initialized():
        return None
    box = [datetime.now().strftime(r"%m%d_%H%M%S") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


@dataclass(frozen=True)
class Mesh:
    """This process's place in a grid of ranks.  ``shape`` maps each axis,
    ``data`` and optionally ``model``, to its size; rank ``r`` sits at
    ``(r // n_model, r % n_model)``.  ``distributed`` is False for the world
    of one process without a process group.  ``device_mesh``, the
    ``torch.distributed`` ``DeviceMesh`` that ``fully_shard`` takes, is built
    for a mesh with a model axis only: a data mesh's one group is the
    world's."""

    shape: tuple
    rank: int
    device: torch.device
    distributed: bool = False
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return int(np.prod([n for _, n in self.shape]))

    def axis_size(self, name: str) -> int:
        return dict(self.shape).get(name, 1)

    @property
    def n_data(self) -> int:
        return self.axis_size(DATA_AXIS)

    @property
    def n_model(self) -> int:
        return self.axis_size(MODEL_AXIS)

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints, samples and logs."""
        return self.rank == 0

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None when nothing
        is distributed)."""
        if not self.distributed:
            return None
        if self.device_mesh is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)


def mesh_of(shape: tuple, device=None) -> Mesh:
    """The mesh of ``shape`` (``((axis, size), ...)``) over the whole world,
    whose size must be the product of the axes' sizes."""
    dev = init_world(device)
    size = int(np.prod([n for _, n in shape]))
    if size != world_size():
        raise ValueError(f"a mesh of {dict(shape)} needs {size} ranks, the world has "
                         f"{world_size()}")
    if not dist.is_initialized():
        return Mesh(shape, 0, dev)
    device_mesh = None
    if len(shape) > 1:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(dev.type, tuple(n for _, n in shape),
                                       mesh_dim_names=tuple(name for name, _ in shape))
    return Mesh(shape, dist.get_rank(), dev, True, device_mesh)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D data mesh over every rank of the world (``n_devices``, where
    given, must be the world's size)."""
    n = world_size() if n_devices is None else int(n_devices)
    return mesh_of(((DATA_AXIS, n),), device)


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (a broadcast over the
    world); nothing to do when nothing is distributed."""
    if mesh.distributed:
        for tensor in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(tensor.data, src=0)
    return module


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every array or tensor of ``batch`` (a tuple, or
    one array): the global batch axis cut into ``n_data`` equal slices in data
    rank order, each replicated over the model axis.  A batch the data axis
    does not divide is refused."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    if mesh.n_data == 1:
        return batch
    rows = batch.shape[0]
    if rows % mesh.n_data:
        raise ValueError(f"global batch {rows} not divisible by {mesh.n_data} data ranks")
    local = rows // mesh.n_data
    return batch[mesh.data_rank * local:(mesh.data_rank + 1) * local]


def _on_card(group) -> bool:
    """Whether ``group``'s collectives take CUDA tensors (NCCL); gloo's take
    host tensors for an all-gather."""
    return "nccl" in str(dist.get_backend(group))


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch on every rank: each data rank's ``local`` rows (equal
    counts) stacked in data rank order, the inverse of :func:`shard_batch`.
    NCCL gathers on the card.  Gloo cannot all-gather CUDA tensors, so under
    gloo, and under ``-d cpu``, it gathers host copies and the result lies on
    the host.  ``local`` itself when the data axis has one rank."""
    if not mesh.distributed or mesh.n_data == 1:
        return local
    group = mesh.group(DATA_AXIS)
    if local.is_cuda and _on_card(group):
        out = local.new_empty((mesh.n_data * local.shape[0],) + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(out, local.contiguous(), group=group)
        return out
    host = local.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.n_data)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts)


def all_finite(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` (a rank's verdict, such as a canary's finite output)
    holds on every rank of the world: an all-reduce of the minimum, so that
    every rank takes the same decision.  ``flag`` itself without a process
    group."""
    if not mesh.distributed:
        return bool(flag)
    on_card = mesh.device.type == "cuda" and _on_card(None)
    verdict = torch.tensor([int(bool(flag))], device=mesh.device if on_card else "cpu")
    dist.all_reduce(verdict, op=dist.ReduceOp.MIN)
    return bool(verdict.item())


def global_mean(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``value`` (a tensor of per-rank means over equal row
    counts) over the data axis; ``value`` itself when that axis has one rank."""
    if not mesh.distributed or mesh.n_data == 1:
        return value
    total = value.detach().clone()
    dist.all_reduce(total, group=mesh.group(DATA_AXIS))
    return total / mesh.n_data


def rank_seed(seed: int, rank: int) -> int:
    """The seed of data rank ``rank``'s generator: ``seed`` itself at rank 0
    (the generator of a run without a process group), and a seed drawn from
    ``(seed, rank)`` on the others."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence((int(seed), int(rank))).generate_state(1, np.uint64)[0]
               >> np.uint64(1))
