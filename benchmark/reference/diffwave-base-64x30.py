"""Plain reference of the DiffWave vocoder (Kong et al. 2021, arXiv:2009.09761)
under the deterministic DDIM sampler, conditioned on the trained step.

The network: the step ``t`` encoded as ``[sin, cos](t * 10 ** (4 k / 63))``
for k < 64, two 512-wide linear layers with SiLU; the spectrogram
``[B, freq, frames]`` upsampled 256x in time by two transposed 2-D
convolutions (kernel 3 x 32, stride 1 x 16, padding 1 x 8), each followed
by leaky ReLU 0.4; the waveform through a 1x1 convolution and ReLU to C
channels; per layer i, a gated residual block: ``y = x + W_d emb``, a
dilated 3-tap convolution (dilation ``2 ** (i % cycle)``) to 2C plus the
1x1 conditioner projection of the upsampled spectrogram, ``sigmoid(gate) *
tanh(filter)``, a 1x1 residual projection (``(x + res) / sqrt 2``) and a
1x1 skip projection; the skips summed over the layers, divided by
``sqrt(L)``, a 1x1 conv with ReLU and a 1x1 conv to one channel.
Parameters under the reference implementation's module names.  Float32,
except the step encoding's argument, formed at the configuration's compute
dtype (``plain.encoding_argument``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import plain


class DiffWave:
    def __init__(self, params: dict, net_args: dict, prec: plain.Precision | None = None,
                 dtype: torch.dtype = torch.float32):
        self.p = params
        self.dtype = dtype
        self.layers = net_args.get("residual_layers", 30)
        self.cycle = net_args.get("dilation_cycle_length", 10)
        self.prec = prec or plain.Precision()

    def _conv1(self, name, x, **kw):
        return self.prec.conv1d(x, self.p[name + ".weight"], self.p[name + ".bias"], **kw)

    def _linear(self, name, x):
        return self.prec.linear(x, self.p[name + ".weight"], self.p[name + ".bias"])

    def _embed(self, step):
        k = np.arange(64, dtype=np.float32) / 64
        freqs = torch.as_tensor(10.0 ** (k * 4.0 / 63.0), dtype=torch.float32, device=step.device)
        x = plain.encoding_argument(step.reshape(-1, 1), freqs[None, :], self.dtype)
        x = torch.cat([torch.sin(x), torch.cos(x)], dim=-1)
        x = F.silu(self._linear("diffusion_embedding.projection1", x))
        return F.silu(self._linear("diffusion_embedding.projection2", x))

    def upsample(self, spec, T: int):
        x = spec[:, None]
        for name in ("spectrogram_upsampler.conv1", "spectrogram_upsampler.conv2"):
            x = self.prec.conv_transpose2d(x, self.p[name + ".weight"], self.p[name + ".bias"],
                                           stride=(1, 16), padding=(1, 8))
            x = F.leaky_relu(x, 0.4)
        x = x[:, 0]
        if x.shape[-1] < T:
            x = F.pad(x, (0, T - x.shape[-1]))
        return x[..., :T]

    def __call__(self, cond_up, x_t, step):
        """``cond_up``: the upsampled spectrogram ``[B, freq, T]``; ``x_t``:
        ``[B, 1, T]``; ``step``: ``[B]``.  Returns the predicted noise."""
        x = F.relu(self._conv1("input_projection", x_t))
        emb = self._embed(step)
        skips = 0.0
        for i in range(self.layers):
            name = f"residual_layers.{i}"
            d = 2 ** (i % self.cycle)
            y = x + self._linear(name + ".diffusion_projection", emb)[:, :, None]
            y = (self._conv1(name + ".dilated_conv", y, padding=d, dilation=d)
                 + self._conv1(name + ".conditioner_projection", cond_up))
            gate, filt = torch.chunk(y, 2, dim=1)
            y = torch.sigmoid(gate) * torch.tanh(filt)
            x = (x + self._conv1(name + ".output_residual", y)) / math.sqrt(2.0)
            skips = skips + self._conv1(name + ".output_projection", y)
        y = F.relu(self._conv1("skip_projection", skips / math.sqrt(self.layers)))
        return self._conv1("output_projection", y)


@torch.no_grad()
def vocode(params: dict, config: dict, spec: torch.Tensor, x_T_noise: torch.Tensor,
           num_steps: int, prec=None) -> torch.Tensor:
    """DDIM (eta 0) over ``num_steps`` steps of the trained schedule from
    ``x_T = z``, the network conditioned on each step's trained step:
    spectrograms ``[B, freq, frames]`` in, waveforms ``[B, 1, T]`` out."""
    args = config["diffusion"]["args"]
    tab, t_map = plain.subsampled(plain.linear_tables(args["n_timestep"], args["linear_start"],
                                                      args["linear_end"]), num_steps)
    net = DiffWave(params, dict(config["network"]["args"]), prec, plain.compute_dtype(config))
    x = x_T_noise
    cond_up = net.upsample(spec, x.shape[-1])
    ones = torch.ones(spec.shape[0], device=spec.device)
    for t in range(len(tab["alpha_bar"]) - 1, 0, -1):
        x = plain.ddim_step(tab, x, t, net(cond_up, x, float(t_map[t]) * ones))
    return x


def stack_shapes(config: dict, rows: int, samples: int) -> dict:
    """The sizes of the residual stack at ``rows`` x ``samples``: B, T, C,
    L, the condition's bins and the embedding's width."""
    a = dict(config["network"]["args"])
    return {"B": rows, "T": samples, "C": a.get("residual_channels", 64),
            "L": a.get("residual_layers", 30), "freq": config["spectrogram"]["stft_bins"],
            "emb": 512}


def forward_flops(config: dict, rows: int, frames: int, hop: int) -> tuple:
    """Model FLOPs on ``rows`` spectrograms of ``frames`` frames, as
    ``torch.utils.flop_counter`` counts them on the meta device: ``(once a
    call, once a step)``.  What does not depend on the step (the upsampler
    and every layer's conditioner projection) is counted once a call."""
    from torch.utils.flop_counter import FlopCounterMode

    a = dict(config["network"]["args"])
    c, L, freq = (a.get("residual_channels", 64), a.get("residual_layers", 30),
                  config["spectrogram"]["stft_bins"])
    shapes = {"input_projection": ((c, 1, 1), (c,)),
              "diffusion_embedding.projection1": ((512, 128), (512,)),
              "diffusion_embedding.projection2": ((512, 512), (512,)),
              "spectrogram_upsampler.conv1": ((1, 1, 3, 32), (1,)),
              "spectrogram_upsampler.conv2": ((1, 1, 3, 32), (1,)),
              "skip_projection": ((c, c, 1), (c,)), "output_projection": ((1, c, 1), (1,))}
    for i in range(L):
        n = f"residual_layers.{i}"
        shapes.update({n + ".dilated_conv": ((2 * c, c, 3), (2 * c,)),
                       n + ".diffusion_projection": ((c, 512), (c,)),
                       n + ".conditioner_projection": ((2 * c, freq, 1), (2 * c,)),
                       n + ".output_residual": ((c, c, 1), (c,)),
                       n + ".output_projection": ((c, c, 1), (c,))})
    params = {}
    for name, (w, b) in shapes.items():
        params[name + ".weight"] = torch.empty(w, device="meta")
        params[name + ".bias"] = torch.empty(b, device="meta")
    net = DiffWave(params, a)
    T = frames * hop
    spec = torch.empty(rows, freq, frames, device="meta")
    x = torch.empty(rows, 1, T, device="meta")
    with FlopCounterMode(display=False) as up:
        cond_up = net.upsample(spec, T)
    with FlopCounterMode(display=False) as fwd:
        net(cond_up, x, torch.empty(rows, device="meta"))
    conditioner = 2 * rows * T * freq * 2 * c * L
    return int(up.get_total_flops()) + conditioner, int(fwd.get_total_flops()) - conditioner
