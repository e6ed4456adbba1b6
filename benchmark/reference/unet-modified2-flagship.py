"""Plain reference of the flagship enhancer: UNetModified2 under SDDM's
noised-condition ancestral sampler, and its training objective.

The network (the reference implementation's ``UNetModified2``): the
condition and the noisy signal, each ``[B, T]``, cut into frames of
``segment_len`` at ``segment_stride`` and stacked as two channels of an
NCHW image ``[B, 2, frames, segment_len]``; a 3x3 input convolution; per
level ``res_blocks`` ResnetBlocks (GroupNorm -> SiLU -> 3x3 conv, plus the
noise embedding's per-channel shift, GroupNorm -> SiLU -> 3x3 conv, plus a
1x1 residual conv where the width changes) and a stride-2 3x3 downsample;
one middle ResnetBlock; a decoder that concatenates each skip, with
nearest 2x upsampling and a 3x3 conv; GroupNorm -> SiLU -> 3x3 conv to one
channel; frames overlap-added back to ``[B, 1, T]``.  The noise level
enters through a sinusoidal encoding of ``level * 1e4`` and a 4x MLP with
SiLU.  Parameters are a dict under the reference implementation's module
names.  Float32 throughout, GroupNorm with eps 1e-5, except the encoding's
argument, formed at the configuration's compute dtype
(``plain.encoding_argument``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import plain


class UNetModified2:
    def __init__(self, params: dict, net_args: dict, num_samples: int,
                 prec: plain.Precision | None = None, on_norm=None,
                 dtype: torch.dtype = torch.float32):
        """``params``: name -> float32 tensor; ``net_args``: the config's
        network args; ``on_norm(x, groups)`` sees the input of every
        GroupNorm+SiLU (the logical sites the byte counts are taken on)."""
        self.p = params
        self.inner = net_args.get("inner_channel", 32)
        self.groups = net_args.get("norm_groups", 32)
        self.mults = tuple(net_args.get("channel_mults", (1, 2, 3, 4, 5)))
        self.res_blocks = net_args.get("res_blocks", 3)
        self.seg = net_args.get("segment_len", 128)
        self.stride = net_args.get("segment_stride", 64)
        self.num_samples = num_samples
        self.prec = prec or plain.Precision()
        self.on_norm = on_norm
        self.dtype = dtype

    # -- layers ---------------------------------------------------------------
    def _conv(self, name, x, **kw):
        return self.prec.conv2d(x, self.p[name + ".weight"], self.p[name + ".bias"], **kw)

    def _linear(self, name, x):
        return self.prec.linear(x, self.p[name + ".weight"], self.p[name + ".bias"])

    def _block(self, name, x):
        if self.on_norm is not None:
            self.on_norm(x, self.groups)
        h = F.group_norm(x, self.groups, self.p[name + ".block.0.weight"],
                         self.p[name + ".block.0.bias"], 1e-5)
        return self._conv(name + ".block.3", F.silu(h), padding=1)

    def _resnet(self, name, x, emb):
        h = self._block(name + ".block1", x)
        h = h + self._linear(name + ".noise_func.noise_func.0", emb)[:, :, None, None]
        h = self._block(name + ".block2", h)
        res = self._conv(name + ".res_conv", x) if name + ".res_conv.weight" in self.p else x
        return h + res

    def _embed(self, level):
        half = self.inner // 2
        k = np.arange(half, dtype=np.float32)
        freqs = torch.as_tensor(1e4 * 10.0 ** (-k * 4.0 / half), dtype=torch.float32,
                                device=level.device)
        x = plain.encoding_argument(level.reshape(-1, 1), freqs[None, :], self.dtype)
        x = torch.cat([torch.sin(x), torch.cos(x)], dim=-1)
        x = F.silu(self._linear("noise_level_mlp.1", x))
        return F.silu(self._linear("noise_level_mlp.3", x))

    # -- framing ----------------------------------------------------------------
    def _frames(self, sig):
        return sig.unfold(-1, self.seg, self.stride)

    def _overlap_add(self, frames):
        """Frames ``[B, n, F]`` summed back at the stride into ``[B, T]``
        (``F`` a multiple of the stride: each frame is ``F / stride`` panes)."""
        b, n, f = frames.shape
        k = f // self.stride
        panes = frames.reshape(b, n, k, self.stride)
        out = frames.new_zeros(b, n + k - 1, self.stride)
        for j in range(k):
            out[:, j:j + n] += panes[:, :, j]
        return out.reshape(b, self.num_samples)

    def __call__(self, condition, x_t, level):
        """``condition``, ``x_t``: ``[B, 1, T]``; ``level``: ``[B]``.
        Returns the predicted noise ``[B, 1, T]``."""
        h = torch.stack([self._frames(condition[:, 0]), self._frames(x_t[:, 0])], dim=1)
        emb = self._embed(level)
        feats = []
        h = self._conv("downs.0", h, padding=1)
        feats.append(h)
        idx = 1
        for _ in self.mults:
            for _ in range(self.res_blocks):
                h = self._resnet(f"downs.{idx}", h, emb)
                feats.append(h)
                idx += 1
            h = self._conv(f"downs.{idx}.conv", h, stride=2, padding=1)
            feats.append(h)
            idx += 1
        h = self._resnet("mid.0", h, emb)
        idx = 0
        for _ in reversed(self.mults):
            h = self._resnet(f"ups.{idx}", torch.cat([h, feats.pop()], dim=1), emb)
            idx += 1
            h = self._conv(f"ups.{idx}.conv", F.interpolate(h, scale_factor=2, mode="nearest"),
                           padding=1)
            idx += 1
            for _ in range(self.res_blocks):
                h = self._resnet(f"ups.{idx}", torch.cat([h, feats.pop()], dim=1), emb)
                idx += 1
        out = self._block("final_conv", h)
        return self._overlap_add(out[:, 0])[:, None, :]


def network(params, config, prec=None, on_norm=None) -> UNetModified2:
    return UNetModified2(params, dict(config["network"]["args"]), config["num_samples"], prec,
                         on_norm, plain.compute_dtype(config))


@torch.no_grad()
def enhance(params: dict, config: dict, condition: torch.Tensor, x_T_noise: torch.Tensor,
            step_noises, num_steps: int, prec=None) -> torch.Tensor:
    """The noised-condition ancestral sampler over ``num_steps`` steps of the
    trained schedule, conditioned on ``sqrt(alpha_bar)``: ``[B, 1, T]`` rows
    in, enhanced rows out.  ``step_noises[i]`` is the draw of the i-th step."""
    args = config["diffusion"]["args"]
    tab, _ = plain.subsampled(plain.linear_tables(args["n_timestep"], args["linear_start"],
                                                  args["linear_end"]), num_steps)
    net = network(params, config, prec)
    x = plain.noised_condition_start(tab, condition, x_T_noise)
    T = len(tab["alpha_bar"]) - 1
    ones = torch.ones(condition.shape[0], device=condition.device)
    for i, t in enumerate(range(T, 0, -1)):
        eps_hat = net(condition, x, plain._f32(tab["sqrt_alpha_bar"][t]) * ones)
        x = plain.ancestral_step(tab, x, t, eps_hat, step_noises[i])
    return x


def train_loss(params: dict, config: dict, target, condition, t, frac, eps, prec=None):
    """The epsilon-prediction objective at WaveGrad's continuous level:
    ``mean |net(y, level x_0 + sqrt(1 - level^2) eps, level) - eps|``."""
    args = config["diffusion"]["args"]
    tab = plain.linear_tables(args["n_timestep"], args["linear_start"], args["linear_end"])
    level = plain.continuous_level(tab, t, frac)
    lb = level[:, None, None]
    x_t = lb * target + torch.sqrt(1.0 - lb * lb) * eps
    return plain.l1(network(params, config, prec)(condition, x_t, level), eps)


def norm_sites(config: dict, rows: int) -> list:
    """The logical input shape ``(B, C, H, W)`` and groups of every
    GroupNorm+SiLU of one forward at ``rows`` rows (shapes on the meta
    device, nothing computed)."""
    sites = []
    params = meta_params(config)
    net = network(params, config, on_norm=lambda x, g: sites.append((tuple(x.shape), g)))
    z = torch.empty(rows, 1, config["num_samples"], device="meta")
    net(z, z, torch.empty(rows, device="meta"))
    return sites


def meta_params(config: dict) -> dict:
    """Every parameter's shape, on the meta device, under its name."""
    a = dict(config["network"]["args"])
    inner, mults, rb = a.get("inner_channel", 32), a.get("channel_mults"), a.get("res_blocks", 3)
    shapes = {"noise_level_mlp.1.weight": (4 * inner, inner), "noise_level_mlp.1.bias": (4 * inner,),
              "noise_level_mlp.3.weight": (inner, 4 * inner), "noise_level_mlp.3.bias": (inner,),
              "downs.0.weight": (inner, a.get("in_channel", 2), 3, 3), "downs.0.bias": (inner,)}

    def conv(name, cin, cout, k=3):
        shapes[name + ".weight"], shapes[name + ".bias"] = (cout, cin, k, k), (cout,)

    def resnet(name, cin, cout):
        for blk, c in (("block1", cin), ("block2", cout)):
            shapes[f"{name}.{blk}.block.0.weight"] = shapes[f"{name}.{blk}.block.0.bias"] = (c,)
            conv(f"{name}.{blk}.block.3", c, cout)
        shapes[f"{name}.noise_func.noise_func.0.weight"] = (cout, inner)
        shapes[f"{name}.noise_func.noise_func.0.bias"] = (cout,)
        if cin != cout:
            conv(f"{name}.res_conv", cin, cout, 1)

    feats, pre, idx = [inner], inner, 1
    for m in mults:
        for _ in range(rb):
            resnet(f"downs.{idx}", pre, inner * m)
            pre = inner * m
            feats.append(pre)
            idx += 1
        conv(f"downs.{idx}.conv", pre, pre)
        feats.append(pre)
        idx += 1
    resnet("mid.0", pre, pre)
    idx = 0
    for ind in reversed(range(len(mults))):
        n_ch = inner * mults[ind]
        resnet(f"ups.{idx}", pre + feats.pop(), n_ch)
        conv(f"ups.{idx + 1}.conv", n_ch, n_ch)
        idx += 2
        pre = n_ch
        n_out = inner if ind == 0 else inner * mults[ind - 1]
        for _ in range(rb):
            resnet(f"ups.{idx}", pre + feats.pop(), n_out)
            pre = n_out
            idx += 1
    shapes["final_conv.block.0.weight"] = shapes["final_conv.block.0.bias"] = (pre,)
    conv("final_conv.block.3", pre, a.get("out_channel", 1))
    return {k: torch.empty(v, device="meta") for k, v in shapes.items()}


def forward_flops(config: dict, rows: int, backward: bool = False) -> int:
    """Model FLOPs of one forward (and its backward) at ``rows`` rows, as
    ``torch.utils.flop_counter`` counts them on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {k: v.requires_grad_(backward) for k, v in meta_params(config).items()}
    z = torch.empty(rows, 1, config["num_samples"], device="meta")
    with FlopCounterMode(display=False) as counter:
        out = network(params, config)(z, z, torch.empty(rows, device="meta"))
        if backward:
            out.sum().backward()
    return int(counter.get_total_flops())
