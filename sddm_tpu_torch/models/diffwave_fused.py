"""FusedDiffWave: DiffWave inference with the residual stack in one kernel
call (counterpart of ``sddm_tpu/models/diffwave_fused.py``).

It wraps a :class:`DiffWave` and computes the same function with the same
parameters.  Two engine hooks of the sampler (``SDDM.infer``) take work out
of the step loop:
  - ``prepare`` stacks the per-layer weights once per ``infer``, cast to the
    network's dtype;
  - ``prepare_condition`` upsamples the spectrogram and projects it through
    every layer's conditioner (plus the dilated conv's bias) once per
    ``infer``: ``cond_l`` of shape ``[L, B, T, 2C]``.
The forward keeps the stem, the embedding chain and the head in PyTorch and
runs the 30 gated layers through :func:`diffwave_stack`, the CUDA kernel on
the card.  Inference only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.diffwave_stack import diffwave_stack
from .diffwave import DiffWave


class FusedDiffWave(nn.Module):
    def __init__(self, net: DiffWave):
        super().__init__()
        self.net = net

    def prepare(self) -> dict:
        """The per-layer weights stacked in the stack kernel's layout, in the
        network's dtype.  The conditioner bias is summed with the dilated
        conv's bias in float32 before the cast, as the JAX engine sums it."""
        dt = self.net.dtype
        layers = self.net.residual_layers

        def stack(fn):
            return torch.stack([fn(layer) for layer in layers])

        wres = stack(lambda m: m.output_residual.weight[:, :, 0].t())   # [L, C, C]
        wskip = stack(lambda m: m.output_projection.weight[:, :, 0].t())
        bres = stack(lambda m: m.output_residual.bias)
        bskip = stack(lambda m: m.output_projection.bias)
        prep = {
            "wconv": stack(lambda m: m.dilated_conv.weight.permute(2, 1, 0)),  # [L, 3, C, 2C]
            "wcond": stack(lambda m: m.conditioner_projection.weight[:, :, 0].t()),  # [L, F, 2C]
            "bcond": stack(lambda m: m.conditioner_projection.bias + m.dilated_conv.bias),
            "wrs": torch.cat([wres, wskip], dim=-1),                         # [L, C, 2C]
            "brs": torch.cat([bres, bskip], dim=-1)[:, None, :],             # [L, 1, 2C]
            "wemb": stack(lambda m: m.diffusion_projection.weight.t()),      # [L, 512, C]
            "bemb": stack(lambda m: m.diffusion_projection.bias),
        }
        for name, conv in (("head0", self.net.skip_projection),
                           ("head1", self.net.output_projection)):
            prep[f"{name}_w"] = conv.weight[:, :, 0].t()                 # [C, C], [C, 1]
            prep[f"{name}_b"] = conv.bias
        return {k: v.detach().to(dt).contiguous() for k, v in prep.items()}

    def prepare_condition(self, prep: dict, condition: torch.Tensor, T: int | None = None) -> dict:
        """``{"cond_l": [L, B, T, 2C]}``: the upsampled spectrogram through
        every layer's conditioner projection, plus the biases; ``T`` defaults
        to the upsampled length."""
        if condition.dim() == 4:
            condition = condition[:, 0]
        if T is None:
            T = condition.shape[-1] * 256
        cond = self.net.upsample_condition(condition, T).transpose(1, 2).contiguous()  # [B, T, F]
        wcond = prep["wcond"]
        cond_l = torch.empty((wcond.shape[0],) + cond.shape[:2] + (wcond.shape[-1],),
                             dtype=cond.dtype, device=cond.device)
        for l in range(wcond.shape[0]):
            torch.matmul(cond, wcond[l], out=cond_l[l])
        cond_l += prep["bcond"][:, None, None, :]
        return {"cond_l": cond_l}

    def forward(self, condition, x_t: torch.Tensor, diffusion_step: torch.Tensor,
                prep: dict | None = None) -> torch.Tensor:
        """``condition``: a spectrogram ``[B, freq, frames]`` or the context
        from :meth:`prepare_condition`; ``x_t``: ``[B, 1, T]``; ``prep``: from
        :meth:`prepare`, computed here when not given.  Returns ``[B, 1, T]``
        in ``x_t``'s dtype."""
        if prep is None:
            prep = self.prepare()
        net = self.net
        T = x_t.shape[-1]
        x0 = net.stem(x_t).transpose(1, 2).contiguous()                      # [B, T, C]
        emb512 = net.diffusion_embedding(diffusion_step.reshape(-1).to(net.dtype))
        emb_d = torch.einsum("be,lec->lbc", emb512, prep["wemb"]) + prep["bemb"][:, None, :]
        if isinstance(condition, dict):
            cond_l = condition["cond_l"][:, :, :T]
        else:
            cond_l = self.prepare_condition(prep, condition, T)["cond_l"]
        skips = diffwave_stack(x0, cond_l.contiguous(), emb_d, prep["wconv"], prep["wrs"],
                               prep["brs"], cycle=net.dilation_cycle_length)
        y = skips / math.sqrt(float(len(net.residual_layers)))
        y = F.relu(y @ prep["head0_w"] + prep["head0_b"])
        y = y @ prep["head1_w"] + prep["head1_b"]
        return y.transpose(1, 2).to(x_t.dtype)
