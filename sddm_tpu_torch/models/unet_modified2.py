"""UNetModified2, the flagship denoiser (counterpart of
``sddm_tpu/models/unet_modified2.py``).

The ``[B, 1, T]`` condition and noisy signal are framed into ``[n_frames,
frame_len]`` windows, stacked as 2 input channels (NCHW ``[B, 2, N, F]``),
run through a 5-level encoder/decoder with the noise level injected in every
ResnetBlock and the skips concatenated in the decoder, and overlap-added back
into a ``[B, 1, T]`` noise estimate.  Module names are the reference's
(``downs.N``, ``mid.0``, ``ups.N``, ``final_conv``, ``noise_level_mlp``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.framing import frame_signal, overlap_add
from .blocks import Block, Conv2d, Downsample, NoiseLevelMLP, ResnetBlock, Upsample


class UNetModified2(nn.Module):
    def __init__(
        self,
        num_samples: int,
        in_channel: int = 2,
        out_channel: int = 1,
        inner_channel: int = 32,
        norm_groups: int = 32,
        channel_mults: Sequence[int] = (1, 2, 3, 4, 5),
        res_blocks: int = 3,
        dropout: float = 0.0,
        segment_len: int = 128,
        segment_stride: int = 64,
        dtype: torch.dtype = torch.float32,
    ):
        """``dropout`` acts only in training, which the port does not run;
        ``dtype`` is the compute dtype (parameters and norm statistics stay
        float32)."""
        super().__init__()
        self.num_samples = num_samples
        self.inner_channel = inner_channel
        self.norm_groups = norm_groups
        self.channel_mults = tuple(channel_mults)
        self.res_blocks = res_blocks
        self.dropout = dropout
        self.segment_len = segment_len
        self.segment_stride = segment_stride
        self.dtype = dtype

        self.noise_level_mlp = NoiseLevelMLP(inner_channel)
        self.downs = nn.ModuleList([Conv2d(in_channel, inner_channel, 3, padding=1)])
        feat_channels = [inner_channel]
        pre = inner_channel
        for mult in channel_mults:
            n_out = inner_channel * mult
            for _ in range(res_blocks):
                self.downs.append(ResnetBlock(pre, n_out, inner_channel, norm_groups))
                pre = n_out
                feat_channels.append(pre)
            self.downs.append(Downsample(pre))
            feat_channels.append(pre)

        self.mid = nn.ModuleList([ResnetBlock(pre, pre, inner_channel, norm_groups)])

        self.ups = nn.ModuleList()
        for ind in reversed(range(len(channel_mults))):
            n_ch = inner_channel * channel_mults[ind]
            self.ups.append(ResnetBlock(pre + feat_channels.pop(), n_ch,
                                        inner_channel, norm_groups))
            self.ups.append(Upsample(n_ch))
            pre = n_ch
            n_out = inner_channel if ind == 0 else inner_channel * channel_mults[ind - 1]
            for _ in range(res_blocks):
                self.ups.append(ResnetBlock(pre + feat_channels.pop(), n_out,
                                            inner_channel, norm_groups))
                pre = n_out

        self.final_conv = Block(pre, out_channel, groups=norm_groups)

    def forward(self, condition: torch.Tensor, x_t: torch.Tensor,
                noise_level: torch.Tensor) -> torch.Tensor:
        """condition, x_t: ``[B, 1, T]``; noise_level: ``[B, 1, 1]`` (any shape
        flattening to ``[B]``).  Returns the predicted noise ``[B, 1, T]``."""
        in_dtype = x_t.dtype
        cond_f = frame_signal(condition[:, 0], self.segment_len, self.segment_stride)
        xt_f = frame_signal(x_t[:, 0], self.segment_len, self.segment_stride)
        h = torch.stack([cond_f, xt_f], dim=1).to(self.dtype)  # [B, 2, N, F]
        t_emb = self.noise_level_mlp(noise_level.to(self.dtype))

        feats = []
        for layer in self.downs:
            h = layer(h, t_emb) if isinstance(layer, ResnetBlock) else layer(h)
            feats.append(h)
        # the conv_in feature (feats[0]) is pushed and never popped, as in JAX
        for layer in self.mid:
            h = layer(h, t_emb)
        for layer in self.ups:
            if isinstance(layer, ResnetBlock):
                h = layer(torch.cat([h, feats.pop()], dim=1), t_emb)
            else:
                h = layer(h)

        out = self.final_conv(h).to(in_dtype)  # [B, 1, N, F]
        return overlap_add(out, self.num_samples, self.segment_stride)
