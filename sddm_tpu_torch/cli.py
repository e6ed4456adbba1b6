"""Shared CLI wiring (counterpart of ``sddm_tpu/cli.py``): the entry points'
argument parser, and the builders of the model objects, datasets, loaders,
loss and metrics from a config (a dict or a ``ConfigParser``), for the
networks and composites the port serves."""

from __future__ import annotations

import argparse
import inspect

import torch

from .data.loaders import DATA_LOADERS, DATASETS
from .diffusion.schedule import DiffusionSchedule
from .models.losses import get_loss
from .models.metrics import get_metric
from .models.diffwave import DiffWave
from .models.diffwave_fused import FusedDiffWave
from .models.sddm import SDDM, SDDM_spectrogram
from .models.unet_modified2 import UNetModified2
from .ops.diffwave_stack import CHANNELS as STACK_CHANNELS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def standard_argparser(description: str) -> argparse.ArgumentParser:
    """``-c`` config, ``-r`` checkpoint to resume from, ``-d`` device."""
    args = argparse.ArgumentParser(description=description)
    args.add_argument("-c", "--config", default=None, type=str,
                      help="config file path (default: None)")
    args.add_argument("-r", "--resume", default=None, type=str,
                      help="path to latest checkpoint (default: None)")
    args.add_argument("-d", "--device", default=None, type=str,
                      help="torch device (e.g. 'cpu'; default: the card); bare GPU "
                           "indices, the reference's use of this slot, are ignored")
    return args


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


def build_dataset(config, name: str, **kwargs):
    return config.init_obj(name, DATASETS, **kwargs)


def build_data_loader(config, name: str, dataset, **kwargs):
    return config.init_obj(name, DATA_LOADERS, dataset, **kwargs)


def build_loss(config):
    return get_loss(config["loss"])


def build_metrics(config):
    return [get_metric(m) for m in config["metrics"]]
