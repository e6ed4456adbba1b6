"""The weight bridge: JAX/flax parameter trees (numpy) to the port's
``state_dict``s.

``state_dict_from_jax`` (UNetModified2) is the inverse of
``sddm_tpu/compat/torch_import.py`` and ``diffwave_state_dict_from_jax`` the
inverse of ``sddm_tpu/compat/zoo_import.py::import_diffwave_state``; both map
the reference PyTorch names onto the flax tree, and the port's modules carry
those names, so the same tables serve both ways:
  - conv kernel ``[kh, kw, I, O]``       -> weight ``[O, I, kh, kw]``;
  - conv1d kernel ``[k, I, O]``          -> weight ``[O, I, k]``;
  - transposed conv ``[kh, kw, I, O]``   -> weight ``[I, O, kh, kw]``, both
    spatial axes flipped (flax runs the kernel as given, torch correlates
    with the flipped kernel);
  - dense kernel ``[I, O]``              -> weight ``[O, I]``;
  - GroupNorm ``scale``                  -> ``weight``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Sequence

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    out[f"{name}.bias"] = _tensor(p["bias"])


def _dense(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _tensor(p["bias"])


def _conv1d(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    out[f"{name}.bias"] = _tensor(p["bias"])


def _conv_transpose2d(out: dict, name: str, p: Mapping) -> None:
    k = np.asarray(p["kernel"])[::-1, ::-1]
    out[f"{name}.weight"] = _tensor(np.transpose(k, (2, 3, 0, 1)))
    out[f"{name}.bias"] = _tensor(p["bias"])


def _block(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.block.0.weight"] = _tensor(p["GroupNorm_0"]["scale"])
    out[f"{name}.block.0.bias"] = _tensor(p["GroupNorm_0"]["bias"])
    _conv(out, f"{name}.block.3", p["Conv_0"])


def _resnet_block(out: dict, name: str, p: Mapping) -> None:
    _block(out, f"{name}.block1", p["Block_0"])
    _dense(out, f"{name}.noise_func.noise_func.0", p["FeatureWiseAffine_0"]["Dense_0"])
    _block(out, f"{name}.block2", p["Block_1"])
    if "Conv_0" in p:
        _conv(out, f"{name}.res_conv", p["Conv_0"])


def state_dict_from_jax(
    params: Mapping,
    channel_mults: Sequence[int] = (1, 2, 3, 4, 5),
    res_blocks: int = 1,
    inner_channel: int = 32,
) -> "OrderedDict[str, torch.Tensor]":
    """Convert flax UNetModified2 params (``{"params": {...}}`` or the inner
    tree) into a ``state_dict`` for :class:`sddm_tpu_torch.models.UNetModified2`.
    ``channel_mults`` and ``res_blocks`` must be the checkpoint's config;
    ``inner_channel`` is accepted for the same signature as the forward map
    and is implied by the weights' shapes."""
    del inner_channel
    p = params["params"] if "params" in params else params
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _dense(out, "noise_level_mlp.1", p["NoiseLevelMLP_0"]["Dense_0"])
    _dense(out, "noise_level_mlp.3", p["NoiseLevelMLP_0"]["Dense_1"])
    _conv(out, "downs.0", p["Conv_0"])

    rb = ds = us = 0
    idx = 1
    for _ in channel_mults:
        for _ in range(res_blocks):
            _resnet_block(out, f"downs.{idx}", p[f"ResnetBlock_{rb}"])
            rb += 1
            idx += 1
        _conv(out, f"downs.{idx}.conv", p[f"Downsample_{ds}"]["Conv_0"])
        ds += 1
        idx += 1

    _resnet_block(out, "mid.0", p[f"ResnetBlock_{rb}"])
    rb += 1

    idx = 0
    for _ in channel_mults:
        _resnet_block(out, f"ups.{idx}", p[f"ResnetBlock_{rb}"])
        rb += 1
        idx += 1
        _conv(out, f"ups.{idx}.conv", p[f"Upsample_{us}"]["Conv_0"])
        us += 1
        idx += 1
        for _ in range(res_blocks):
            _resnet_block(out, f"ups.{idx}", p[f"ResnetBlock_{rb}"])
            rb += 1
            idx += 1

    _block(out, "final_conv", p["Block_0"])
    return out


def diffwave_state_dict_from_jax(
    params: Mapping, residual_layers: int = 30,
) -> "OrderedDict[str, torch.Tensor]":
    """Convert flax DiffWave params (``{"params": {...}}`` or the inner tree)
    into a ``state_dict`` for :class:`sddm_tpu_torch.models.DiffWave` with
    ``residual_layers`` blocks."""
    p = params["params"] if "params" in params else params
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _conv1d(out, "input_projection", p["Conv_0"])
    _dense(out, "diffusion_embedding.projection1", p["DiffusionEmbedding_0"]["Dense_0"])
    _dense(out, "diffusion_embedding.projection2", p["DiffusionEmbedding_0"]["Dense_1"])
    ups = p["SpectrogramUpsampler_0"]
    _conv_transpose2d(out, "spectrogram_upsampler.conv1", ups["ConvTranspose_0"])
    _conv_transpose2d(out, "spectrogram_upsampler.conv2", ups["ConvTranspose_1"])
    for i in range(residual_layers):
        block, name = p[f"ResidualBlock_{i}"], f"residual_layers.{i}"
        _conv1d(out, f"{name}.dilated_conv", block["Conv_0"])
        _dense(out, f"{name}.diffusion_projection", block["Dense_0"])
        _conv1d(out, f"{name}.conditioner_projection", block["Conv_1"])
        _conv1d(out, f"{name}.output_residual", block["Conv_2"])
        _conv1d(out, f"{name}.output_projection", block["Conv_3"])
    _conv1d(out, "skip_projection", p["Conv_1"])
    _conv1d(out, "output_projection", p["Conv_2"])
    return out
