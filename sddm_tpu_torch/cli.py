"""Build the port's model objects from a config dict (counterpart of
``sddm_tpu/cli.py::build_diffusion``, ``build_network`` and ``build_arch``,
for the networks and composites the port serves)."""

from __future__ import annotations

import inspect

import torch

from .diffusion.schedule import DiffusionSchedule
from .models.diffwave import DiffWave
from .models.diffwave_fused import FusedDiffWave
from .models.sddm import SDDM, SDDM_spectrogram
from .models.unet_modified2 import UNetModified2
from .ops.diffwave_stack import CHANNELS as STACK_CHANNELS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_diffusion(config) -> DiffusionSchedule:
    """Schedule tables from the config's ``diffusion`` block."""
    if config["diffusion"]["type"] != "GaussianDiffusion":
        raise NotImplementedError(config["diffusion"]["type"])
    return DiffusionSchedule.create(**dict(config["diffusion"]["args"]))


def _accepted(cls, args: dict) -> dict:
    """``args`` without the keys ``cls.__init__`` does not take, as the JAX
    package filters a config's args against the module's dataclass fields."""
    params = inspect.signature(cls.__init__).parameters
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return args
    return {k: v for k, v in args.items() if k in params}


def build_network(config, num_samples: int | None = None, device=None):
    """The denoiser: ``UNetModified2`` (which needs ``num_samples``) or
    ``DiffWave``, whose ``freq_bins`` default to the config's spectrogram as
    the root ``test.py`` reads them (``spectrogram.freq_bins``, else
    ``stft_bins``, else ``mel_spectrogram.n_mels``, else 128).  Config args
    the module does not take are dropped.  A top-level ``"dtype":
    "bfloat16"`` selects bf16 compute (parameters and norm statistics stay
    float32).

    ``"packed": true`` gives DiffWave's fused engine, ``FusedDiffWave``, as
    in the JAX package.  On the CPU it serves any width; its residual-stack
    kernel takes 32 or 64 residual channels, so other counts are refused
    here when ``device`` (where the network is to run) is a card.  For
    UNetModified2 it names
    the space-to-depth engine, which ``load_enhancer`` serves by default
    (``PackedUNetModified2``, inference only: dropout must be 0, as the JAX
    package requires); this returns the plain network it is packed from.
    The packed training engine of the JAX package is not ported."""
    net_cfg = config["network"]
    args = dict(net_cfg["args"])
    dtype_name = config.get("dtype")
    if dtype_name and "dtype" not in args:
        args["dtype"] = _DTYPES[dtype_name]
    packed = bool(config.get("packed"))
    if net_cfg["type"] == "UNetModified2":
        net = UNetModified2(num_samples=num_samples, **_accepted(UNetModified2, args))
        if packed and net.dropout:
            raise ValueError('"packed": true serves the packed engine, which is inference-only '
                             f"and requires dropout=0, got dropout={net.dropout}")
        return net
    if net_cfg["type"] == "DiffWave":
        spec = config.get("spectrogram", {})
        args.setdefault("freq_bins", spec.get("freq_bins") or spec.get("stft_bins")
                        or config.get("mel_spectrogram", {}).get("n_mels", 128))
        net = DiffWave(**_accepted(DiffWave, args))
        if not packed:
            return net
        on_card = device is not None and torch.device(device).type == "cuda"
        if on_card and net.residual_channels not in STACK_CHANNELS:
            raise ValueError(
                f'"packed": true serves FusedDiffWave, whose residual-stack kernel takes '
                f"residual_channels in {STACK_CHANNELS} (at 128 the staged weights exceed "
                f"an H100 block's shared memory), got {net.residual_channels}; remove the "
                "flag to serve the plain DiffWave on the card")
        return FusedDiffWave(net)
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
