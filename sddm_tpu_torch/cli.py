"""Build the port's model objects from a config dict (counterpart of
``sddm_tpu/cli.py::build_diffusion``, ``build_network`` and ``build_arch``,
for the networks and composites the port serves)."""

from __future__ import annotations

import torch

from .diffusion.schedule import DiffusionSchedule
from .models.diffwave import DiffWave
from .models.diffwave_fused import FusedDiffWave
from .models.sddm import SDDM, SDDM_spectrogram
from .models.unet_modified2 import UNetModified2

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_diffusion(config) -> DiffusionSchedule:
    """Schedule tables from the config's ``diffusion`` block."""
    if config["diffusion"]["type"] != "GaussianDiffusion":
        raise NotImplementedError(config["diffusion"]["type"])
    return DiffusionSchedule.create(**dict(config["diffusion"]["args"]))


def build_network(config, num_samples: int | None = None):
    """The denoiser: ``UNetModified2`` (which needs ``num_samples``) or
    ``DiffWave``, whose ``freq_bins`` default to the config's spectrogram as
    the root ``test.py`` reads them (``spectrogram.freq_bins``, else
    ``stft_bins``, else ``mel_spectrogram.n_mels``, else 128).  A top-level
    ``"dtype": "bfloat16"`` selects bf16 compute (parameters and norm
    statistics stay float32).  ``"packed": true`` gives
    DiffWave's fused engine, ``FusedDiffWave``, as in the JAX package; for
    UNetModified2 it names the JAX package's space-to-depth engine, which
    computes the same function, and the port serves the plain network."""
    net_cfg = config["network"]
    args = dict(net_cfg["args"])
    dtype_name = config.get("dtype")
    if dtype_name and "dtype" not in args:
        args["dtype"] = _DTYPES[dtype_name]
    if net_cfg["type"] == "UNetModified2":
        return UNetModified2(num_samples=num_samples, **args)
    if net_cfg["type"] == "DiffWave":
        spec = config.get("spectrogram", {})
        args.setdefault("freq_bins", spec.get("freq_bins") or spec.get("stft_bins")
                        or config.get("mel_spectrogram", {}).get("n_mels", 128))
        net = DiffWave(**args)
        return FusedDiffWave(net) if config.get("packed") else net
    raise KeyError(f"network {net_cfg['type']!r} is not ported; "
                   "available: ['DiffWave', 'UNetModified2']")


def build_arch(config, diffusion, network, **kwargs) -> SDDM:
    """The composite of the config's ``arch`` block; ``kwargs`` add to its
    args (``hop_samples`` and ``feature_fn`` for ``SDDM_spectrogram``)."""
    arch = config["arch"]
    args = {**dict(arch.get("args", {})), **kwargs}
    if arch["type"] == "SDDM":
        return SDDM(diffusion, network, **args)
    if arch["type"] == "SDDM_spectrogram":
        return SDDM_spectrogram(diffusion, network, **args)
    raise NotImplementedError(arch["type"])
