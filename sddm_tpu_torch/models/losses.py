"""Training losses (counterpart of ``sddm_tpu/models/losses.py``)."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def log_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean |d| over the last axis, clamped at 1e-20, log, then the mean."""
    per = torch.mean(torch.abs(pred - target), dim=-1)
    return torch.mean(torch.log(torch.clamp(per, min=1e-20)))


LOSSES = {"l1_loss": l1_loss, "l2_loss": l2_loss, "log_loss": log_loss}


def get_loss(name: str):
    return LOSSES[name]
