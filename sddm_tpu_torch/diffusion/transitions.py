"""Reverse diffusion transitions and sampler initialisation (counterpart of
``sddm_tpu/diffusion/transitions.py``; the serving subset).

``t`` is a Python int step in ``[1, T]``: the port's sampler is a Python
loop, so each coefficient is a 0-d float32 tensor read from the schedule
tables and the arithmetic is the JAX package's, in the same order.  Each
function takes an optional pre-drawn N(0, 1) ``noise``; without it the noise
comes from ``generator``.
"""

from __future__ import annotations

import torch

from .schedule import DiffusionSchedule


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)


def _noise_gate(t: int) -> float:
    """1.0 where noise is added (t > 1), else 0.0."""
    return float(t > 1)


def _randn(like: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def p_transition(
    sched: DiffusionSchedule,
    x_t: torch.Tensor,
    t: int,
    predicted: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ho-2020 / WaveGrad ancestral reverse step."""
    mean = (x_t - sched.predicted_noise_coeff[t] * predicted) / torch.sqrt(
        sched.alphas[t])
    if noise is None:
        noise = _randn(x_t, generator)
    x_t_1 = mean + _noise_gate(t) * sched.sigma[t] * noise
    return _clip(x_t_1)


def p_transition_ddim(
    sched: DiffusionSchedule,
    x_t: torch.Tensor,
    t: int,
    predicted: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    eta: float = 0.0,
) -> torch.Tensor:
    """DDIM reverse step; ``eta=0`` is deterministic and draws no noise.
    Index 0 of the tables has alpha_bar = 1, so t = 1 lands on x0_hat."""
    ab_t = sched.alpha_bar[t]
    ab_prev = sched.alpha_bar[t - 1]
    x0_hat = (x_t - torch.sqrt(1.0 - ab_t) * predicted) / torch.sqrt(ab_t)
    sigma = eta * torch.sqrt(torch.clamp_min((1.0 - ab_prev) / (1.0 - ab_t), 0.0)) \
        * torch.sqrt(torch.clamp_min(1.0 - ab_t / ab_prev, 0.0))
    dir_coeff = torch.sqrt(torch.clamp_min(1.0 - ab_prev - torch.square(sigma), 0.0))
    x_t_1 = torch.sqrt(ab_prev) * x0_hat + dir_coeff * predicted
    if eta != 0.0:
        if noise is None:
            noise = _randn(x_t, generator)
        x_t_1 = x_t_1 + _noise_gate(t) * sigma * noise
    return _clip(x_t_1)


def get_x_T(
    sched: DiffusionSchedule,
    condition: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """x_T = sqrt_ab[T] * y + sqrt(1 - ab[T]) * eps (noised-condition start)."""
    if noise is None:
        noise = _randn(condition, generator)
    level = sched.sqrt_alpha_bar[sched.num_timesteps]
    return level * condition + torch.sqrt(1.0 - torch.square(level)) * noise


def get_noise_level(sched: DiffusionSchedule, t: int) -> torch.Tensor:
    """Noise level = sqrt_alpha_bar[t]."""
    return sched.sqrt_alpha_bar[t]
