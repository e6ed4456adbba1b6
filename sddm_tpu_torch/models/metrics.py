"""Speech metrics on tensors (counterpart of ``sddm_tpu/models/metrics.py``):
``sisnr`` and ``segment_sisnr``.  The host scorers (STOI, PESQ) are in
``sddm_tpu_torch.evaluate``."""

from __future__ import annotations

import torch


def sisnr(s_hat: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SNR in dB, meaned over the batch; returns a scalar."""
    if s_hat.dim() == 2:
        s_hat = s_hat[:, None, :]
    if s.dim() == 2:
        s = s[:, None, :]
    s_hat = s_hat - torch.mean(s_hat, dim=-1, keepdim=True)
    s = s - torch.mean(s, dim=-1, keepdim=True)
    s_shat = torch.sum(s_hat * s, dim=-1, keepdim=True)
    s_2 = torch.sum(s**2, dim=-1, keepdim=True)
    s_target = s_shat * s / s_2
    e_noise = s_hat - s_target
    ratio = (torch.sum(s_target**2, dim=-1, keepdim=True)
             / torch.sum(e_noise**2, dim=-1, keepdim=True))
    return torch.squeeze(torch.mean(10.0 * torch.log10(ratio)))


def segment_sisnr(s_hat: torch.Tensor, s: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Per-segment SI-SNR; inputs ``[..., n_segments, L]``, returns ``[B, n]``
    (singleton dims squeezed).

    Guarded against degenerate segments, as in the JAX package: an exactly
    silent clean segment (``sum(s^2) == 0``) maps to a finite ~-80 dB "all
    noise" label instead of dividing by zero, and a noise-free segment
    (``e_noise == 0``) to a finite ~+80 dB one instead of log10(+inf).  For
    ordinary segments the eps terms move the label by O(eps / energy)."""
    s_hat = s_hat - torch.mean(s_hat, dim=-1, keepdim=True)
    s = s - torch.mean(s, dim=-1, keepdim=True)
    s_shat = torch.sum(s_hat * s, dim=-1, keepdim=True)
    s_2 = torch.sum(s**2, dim=-1, keepdim=True)
    s_target = s_shat * s / (s_2 + eps)
    e_noise = s_hat - s_target
    out = 10.0 * torch.log10((torch.sum(s_target**2, dim=-1, keepdim=True) + eps)
                             / (torch.sum(e_noise**2, dim=-1, keepdim=True) + eps))
    return torch.squeeze(out)


METRICS = {"sisnr": sisnr}


def get_metric(name: str):
    return METRICS[name]
