"""Denoiser building blocks (counterpart of ``sddm_tpu/models/blocks.py``).

NCHW inside the network (``[B, C, n_frames, frame_len]``), torch's own
layout.  Parameters stay float32; ``Conv2d`` and ``Linear`` compute in their
input's dtype, so a bfloat16 input gives bfloat16 compute, as flax modules
built with ``dtype=bfloat16`` do.  Module and attribute names are the
reference PyTorch model's (``block.0``, ``block.3``, ``noise_func.noise_func.0``,
``res_conv``, ``conv``), the names ``sddm_tpu.compat.torch_import`` maps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gn_silu import gn_silu


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class GroupNormSiLU(nn.Module):
    """GroupNorm(eps=1e-5) with f32 statistics and affine, then SiLU, cast back
    to the input dtype: flax ``GroupNorm(dtype=float32)`` -> swish ->
    ``astype(x.dtype)``.  Runs :func:`gn_silu`, the CUDA kernel on the card."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gn_silu(x.contiguous(), self.weight, self.bias, self.num_groups, self.eps)


class PositionalEncoding(nn.Module):
    """Sinusoidal noise-level encoding: ``concat[sin, cos](level * 1e4 *
    10**(-4 k / half))``; any input shape is flattened to ``[B, 1]``."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim

    def forward(self, level: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        step = np.arange(half_dim, dtype=np.float32)
        vector = torch.as_tensor(1e4 * 10.0 ** (-step * 4.0 / half_dim),
                                 dtype=level.dtype, device=level.device)
        x = level.reshape(-1, 1) * vector[None, :]
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class FeatureWiseAffine(nn.Module):
    """Adds a per-channel projection of the noise embedding to the feature map."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.noise_func = nn.Sequential(Linear(in_channels, out_channels))

    def forward(self, x: torch.Tensor, noise_embed: torch.Tensor) -> torch.Tensor:
        h = self.noise_func(noise_embed.to(x.dtype))
        return x + h.reshape(x.shape[0], -1, 1, 1)


class Block(nn.Module):
    """GroupNorm -> SiLU -> (dropout) -> 3x3 conv.  Slot 0 runs the fused
    GroupNorm+SiLU; slots 1 and 2 (the reference's Swish and Dropout) are
    identities at inference, kept so that the conv is ``block.3``."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32):
        super().__init__()
        self.block = nn.Sequential(
            GroupNormSiLU(groups, dim), nn.Identity(), nn.Identity(),
            Conv2d(dim, dim_out, 3, padding=1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class ResnetBlock(nn.Module):
    """Block -> FeatureWiseAffine(noise) -> Block -> + residual (1x1 conv
    where the channel count changes)."""

    def __init__(self, dim: int, dim_out: int, noise_dim: int, norm_groups: int = 32):
        super().__init__()
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.noise_func = FeatureWiseAffine(noise_dim, dim_out)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups)
        self.res_conv = Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x)
        h = self.noise_func(h, time_emb)
        h = self.block2(h)
        return h + self.res_conv(x)


class Downsample(nn.Module):
    """Stride-2 3x3 conv with padding 1 on both sides, channels preserved."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """2x nearest upsample, then a 3x3 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class NoiseLevelMLP(nn.Sequential):
    """PositionalEncoding -> Linear(4x) -> SiLU -> Linear(1x) -> SiLU."""

    def __init__(self, channel: int):
        super().__init__(
            PositionalEncoding(channel), Linear(channel, channel * 4), nn.SiLU(),
            Linear(channel * 4, channel), nn.SiLU(),
        )
