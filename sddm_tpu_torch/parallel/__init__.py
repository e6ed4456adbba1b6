"""Training and serving over many ranks (counterpart of ``sddm_tpu/parallel``):
the world and its meshes (``mesh``: also the row gather and the verdict
reduction that ``enhance.Enhancer`` serves a batch with), per-rank dataset
shards (``multihost``), channel tensor parallelism (``tensor``) and
:func:`parallel_model`, which the trainers call to run their step over a
mesh."""

from __future__ import annotations

import copy

import torch

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_finite,
    gather_rows,
    global_mean,
    init_world,
    make_mesh,
    rank_seed,
    replicate,
    shard_batch,
)
from .multihost import PerHostLoader, process_shard_indices, shard_loader
from .tensor import PACKED_REFUSAL, leaf_spec, make_mesh_2d, shard_state, state_shardings

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "PerHostLoader",
    "all_finite",
    "data_parallel",
    "gather_rows",
    "global_mean",
    "init_world",
    "leaf_spec",
    "make_mesh",
    "make_mesh_2d",
    "parallel_model",
    "process_shard_indices",
    "rank_seed",
    "replicate",
    "shard_batch",
    "shard_loader",
    "shard_state",
    "state_shardings",
]


class _Routed:
    """A network whose calls go through its DDP wrapper and whose attributes
    (``prepare``, ``dtype``, ...) are the module's own."""

    def __init__(self, wrapper):
        self.wrapper = wrapper

    def __call__(self, *args, **kwargs):
        return self.wrapper(*args, **kwargs)

    def __getattr__(self, name):
        if name == "wrapper":
            raise AttributeError(name)
        return getattr(self.wrapper.module, name)


def data_parallel(module: torch.nn.Module, mesh: Mesh):
    """``module`` under DDP over ``mesh``'s data axis (rank 0's weights
    broadcast, gradients averaged); ``module`` itself when nothing is
    distributed.  ``static_graph``: a step runs the same graph every time,
    and DDP then lets parameters that get no gradient (a step hands the
    optimizer none for them, which it reads as zero) pass."""
    if not mesh.distributed:
        return module
    from torch.nn.parallel import DistributedDataParallel

    device_ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=device_ids,
                                   process_group=mesh.group(DATA_AXIS), static_graph=True,
                                   broadcast_buffers=False)


def parallel_model(model, optimizer, mesh: Mesh):
    """The composite the train step runs on ``mesh``: ``model`` itself when
    nothing is distributed; a copy whose network runs under DDP on a data
    mesh; ``model``, its network and ``optimizer`` sharded in place
    (:func:`tensor.shard_state`) on a mesh with a model axis, where a packed
    engine is refused as the JAX package refuses it."""
    if mesh.n_model > 1:
        if getattr(model.network, "prepare", None) is not None:
            raise ValueError(PACKED_REFUSAL)
        shard_state(model.network, optimizer, mesh)
        return model
    if not mesh.distributed:
        return model
    routed = copy.copy(model)
    routed.network = _Routed(data_parallel(model.network, mesh))
    return routed
