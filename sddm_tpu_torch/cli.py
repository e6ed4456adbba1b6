"""Build the port's model objects from a config dict (counterpart of
``sddm_tpu/cli.py::build_diffusion``, ``build_network`` and ``build_arch``,
for the ``SDDM`` + ``UNetModified2`` pair the port serves)."""

from __future__ import annotations

import torch

from .diffusion.schedule import DiffusionSchedule
from .models.sddm import SDDM
from .models.unet_modified2 import UNetModified2

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_diffusion(config) -> DiffusionSchedule:
    """Schedule tables from the config's ``diffusion`` block."""
    if config["diffusion"]["type"] != "GaussianDiffusion":
        raise NotImplementedError(config["diffusion"]["type"])
    return DiffusionSchedule.create(**dict(config["diffusion"]["args"]))


def build_network(config, num_samples: int) -> UNetModified2:
    """The denoiser, a ``UNetModified2`` (the one network the port serves).
    A top-level ``"dtype": "bfloat16"`` selects bf16 compute (parameters
    and norm statistics stay float32).  ``"packed": true`` names the JAX
    package's space-to-depth engine, which computes the same function; the
    port serves it through the plain network."""
    net_cfg = config["network"]
    if net_cfg["type"] != "UNetModified2":
        raise KeyError(f"network {net_cfg['type']!r} is not ported; "
                       "available: ['UNetModified2']")
    args = dict(net_cfg["args"])
    dtype_name = config.get("dtype")
    if dtype_name and "dtype" not in args:
        args["dtype"] = _DTYPES[dtype_name]
    return UNetModified2(num_samples=num_samples, **args)


def build_arch(config, diffusion, network) -> SDDM:
    arch = config["arch"]
    if arch["type"] != "SDDM":
        raise NotImplementedError(arch["type"])
    return SDDM(diffusion, network, **dict(arch.get("args", {})))
