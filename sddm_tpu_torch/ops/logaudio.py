"""Log-modulus companding of waveforms (counterpart of
``sddm_tpu/ops/logaudio.py``)."""

from __future__ import annotations

import torch


def log_modulus_normalize(audio: torch.Tensor, expand_order: float = 3) -> torch.Tensor:
    """sign(x) * log10(|x * 10^order| + 1) / (2 * order); maps (-1, 1) to (-1, 1)."""
    out = torch.sign(audio) * torch.log10(torch.abs(10.0**expand_order * audio) + 1.0)
    return out / (2 * expand_order)


def log_modulus_normalize_reverse(audio_log_modulus: torch.Tensor,
                                  expand_order: float = 3) -> torch.Tensor:
    """The inverse of :func:`log_modulus_normalize`."""
    x = audio_log_modulus * 2 * expand_order
    return torch.sign(x) * (torch.pow(10.0, torch.abs(x)) - 1.0) / 10.0**expand_order
