"""DiffWave, the gated dilated-conv diffusion vocoder (counterpart of
``sddm_tpu/models/diffwave.py``).

A t-indexed ``DiffusionEmbedding`` (128 -> 512 -> 512, SiLU), a
``SpectrogramUpsampler`` (two 16x transposed convolutions in time with
leaky_relu 0.4), a C_in=1 stem, and gated residual blocks with dilations
``2 ** (i % cycle)`` whose skips are summed and scaled by ``1/sqrt(L)``.
Torch's NCL layout inside; the module names are the reference PyTorch
model's (``input_projection``, ``residual_layers.N.dilated_conv``, ...), the
names ``sddm_tpu.compat.zoo_import.import_diffwave_state`` maps.  Parameters
stay float32 and every layer computes in the network's ``dtype``, as the flax
modules do when built with ``dtype=bfloat16``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Linear


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with float32 parameters that computes in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with float32 parameters that computes in the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  self.stride, self.padding)


class DiffusionEmbedding(nn.Module):
    """``t`` -> ``[sin, cos](t * 10 ** ((arange(64) / 64) * 4 / 63))`` -> Linear(512)
    -> SiLU -> Linear(512) -> SiLU, in ``t``'s dtype."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        self.projection1 = Linear(dim, 512)
        self.projection2 = Linear(512, 512)

    def forward(self, diffusion_step: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        step = np.arange(half, dtype=np.float32) / half
        vector = torch.as_tensor(10.0 ** (step * 4.0 / 63.0), dtype=diffusion_step.dtype,
                                 device=diffusion_step.device)
        x = diffusion_step.reshape(-1, 1) * vector[None, :]
        x = torch.cat([torch.sin(x), torch.cos(x)], dim=-1)
        x = F.silu(self.projection1(x))
        return F.silu(self.projection2(x))


class SpectrogramUpsampler(nn.Module):
    """``[B, freq, frames]`` -> ``[B, freq, 256 * frames]``: two
    ``ConvTranspose2d(1, 1, (3, 32), stride=(1, 16), padding=(1, 8))``, each
    followed by leaky_relu(0.4)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvTranspose2d(1, 1, (3, 32), stride=(1, 16), padding=(1, 8))
        self.conv2 = ConvTranspose2d(1, 1, (3, 32), stride=(1, 16), padding=(1, 8))

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(spec.unsqueeze(1)), 0.4)
        x = F.leaky_relu(self.conv2(x), 0.4)
        return x.squeeze(1)


class ResidualBlock(nn.Module):
    """Gated dilated residual block (the split branch): returns
    ``((x + res) / sqrt(2), skip)``."""

    def __init__(self, freq_bins: int, residual_channels: int, dilation: int):
        super().__init__()
        c = residual_channels
        self.dilated_conv = Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = Linear(512, c)
        self.conditioner_projection = Conv1d(freq_bins, 2 * c, 1)
        self.output_residual = Conv1d(c, c, 1)
        self.output_projection = Conv1d(c, c, 1)

    def forward(self, x, conditioner, diffusion_emb):
        # x: [B, C, T]; conditioner: [B, freq, T]; diffusion_emb: [B, 512]
        y = x + self.diffusion_projection(diffusion_emb)[:, :, None]
        y = self.dilated_conv(y) + self.conditioner_projection(conditioner)
        gate, filt = torch.chunk(y, 2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        return (x + self.output_residual(y)) / math.sqrt(2.0), self.output_projection(y)


class DiffWave(nn.Module):
    def __init__(self, freq_bins: int = 128, residual_channels: int = 64,
                 residual_layers: int = 30, dilation_cycle_length: int = 10,
                 dtype: torch.dtype = torch.float32):
        """``dtype`` is the compute dtype (parameters stay float32)."""
        super().__init__()
        self.residual_channels = residual_channels
        self.dilation_cycle_length = dilation_cycle_length
        self.dtype = dtype
        self.input_projection = Conv1d(1, residual_channels, 1)
        self.diffusion_embedding = DiffusionEmbedding()
        self.spectrogram_upsampler = SpectrogramUpsampler()
        self.residual_layers = nn.ModuleList([
            ResidualBlock(freq_bins, residual_channels, 2 ** (i % dilation_cycle_length))
            for i in range(residual_layers)])
        self.skip_projection = Conv1d(residual_channels, residual_channels, 1)
        self.output_projection = Conv1d(residual_channels, 1, 1)

    def stem(self, audio: torch.Tensor) -> torch.Tensor:
        """relu of the C_in=1 pointwise conv as a broadcast multiply, as the
        JAX package computes it: ``[B, 1, T]`` -> ``[B, C, T]``."""
        w = self.input_projection.weight.to(self.dtype)[:, 0, 0]
        b = self.input_projection.bias.to(self.dtype)
        return F.relu(audio.to(self.dtype) * w[None, :, None] + b[None, :, None])

    def upsample_condition(self, condition: torch.Tensor, T: int) -> torch.Tensor:
        """``[B, freq, frames]`` (or ``[B, 1, freq, frames]``) -> ``[B, freq, T]``
        in ``dtype``: upsampled, then zero-padded or cropped to ``T``."""
        if condition.dim() == 4:
            condition = condition[:, 0]
        cond = self.spectrogram_upsampler(condition.to(self.dtype))
        if cond.shape[-1] < T:
            cond = F.pad(cond, (0, T - cond.shape[-1]))
        return cond[..., :T]

    def forward(self, condition: torch.Tensor, x_t: torch.Tensor,
                diffusion_step: torch.Tensor) -> torch.Tensor:
        """condition: spectrogram ``[B, freq, frames]``; x_t: audio ``[B, 1, T]``;
        diffusion_step: t (any shape flattening to ``[B]``).  Returns ``[B, 1, T]``
        in ``x_t``'s dtype."""
        x = self.stem(x_t)
        emb = self.diffusion_embedding(diffusion_step.to(self.dtype))
        cond = self.upsample_condition(condition, x_t.shape[-1])
        skips = None
        for layer in self.residual_layers:
            x, skip = layer(x, cond, emb)
            skips = skip if skips is None else skips + skip
        y = skips / math.sqrt(len(self.residual_layers))
        y = F.relu(self.skip_projection(y))
        return self.output_projection(y).to(x_t.dtype)
