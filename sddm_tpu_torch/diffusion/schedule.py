"""Diffusion noise-schedule tables (counterpart of ``sddm_tpu/diffusion/schedule.py``).

Every table is built on the host in float64 and then cast, exactly as in the
JAX package, so the port's coefficients are the same float32 numbers.  All
per-step tables have length ``T + 1``: index 0 is a zero pad and the valid
diffusion steps are ``1..T``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Standalone beta-schedule factory (length-T float64 arrays)."""
    if schedule == "quad":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    elif schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        f = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        f = f / f[0]
        betas = np.clip(1 - f[1:] / f[:-1], a_min=None, a_max=0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


def _warmup_beta(linear_start, linear_end, n_timestep, warmup_frac):
    betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * warmup_frac)
    betas[:warmup_time] = np.linspace(linear_start, linear_end, warmup_time,
                                      dtype=np.float64)
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-step coefficient tables, each a ``[T + 1]`` tensor (index 0 pad)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bar: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sigma: torch.Tensor
    predicted_noise_coeff: torch.Tensor
    supportive_gamma: torch.Tensor
    supportive_sigma_hat: torch.Tensor
    m: torch.Tensor
    sqrt_delta: torch.Tensor
    c_xt: torch.Tensor
    c_yt: torch.Tensor
    c_epst: torch.Tensor
    sqrt_delta_estimated: torch.Tensor
    num_timesteps: int = 0

    @classmethod
    def create(
        cls,
        schedule: str = "linear",
        n_timestep: int = 1000,
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        dtype: torch.dtype = torch.float32,
    ) -> "DiffusionSchedule":
        """Build all tables on the host in float64, then cast to ``dtype``."""
        T = n_timestep
        betas = np.zeros(T + 1, dtype=np.float64)
        if schedule == "linear":
            betas[1:] = np.linspace(linear_start, linear_end, T, dtype=np.float64)
            alpha_bar = np.cumprod(1.0 - betas)
        elif schedule == "quad":
            betas[1:] = np.linspace(linear_start**0.5, linear_end**0.5, T,
                                    dtype=np.float64) ** 2
            alpha_bar = np.cumprod(1.0 - betas)
        elif schedule == "cosine":
            cosine_s = 0.008
            timesteps = np.arange(T + 1, dtype=np.float64) / T + cosine_s
            f = np.cos(timesteps / (1 + cosine_s) * (math.pi / 2)) ** 2
            # alpha_bar comes from the curve; betas from its ratio, clipped
            # without recomputing alpha_bar (the reference's order)
            alpha_bar = f / f[0]
            betas[1:] = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
            betas = np.clip(betas, a_min=None, a_max=0.999)
        else:
            raise NotImplementedError(schedule)
        tables = _tables_from_alpha_bar(alpha_bar, betas=betas)
        return cls(**{k: _cast(v, dtype) for k, v in tables.items()},
                   num_timesteps=T)

    def to(self, device) -> "DiffusionSchedule":
        """The same tables on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_timesteps"
        })


def _cast(values: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    # float64 -> float32 rounding in numpy, as jnp.asarray(x, float32) does
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return torch.from_numpy(np.asarray(values, dtype=np_dtype))


def _tables_from_alpha_bar(alpha_bar: np.ndarray,
                           betas: np.ndarray | None = None) -> dict:
    """Every coefficient table from a (T+1)-long alpha_bar (index 0 == 1.0);
    the closed forms of the reference's model/diffusion.py:98-161."""
    if betas is None:
        betas = np.zeros_like(alpha_bar)
        betas[1:] = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
    alphas = 1.0 - betas
    sqrt_alpha_bar = np.sqrt(alpha_bar)

    sigma = np.zeros_like(betas)
    sigma[1:] = ((1.0 - alpha_bar[:-1]) / (1.0 - alpha_bar[1:]) * betas[1:]) ** 0.5
    predicted_noise_coeff = np.zeros_like(betas)
    predicted_noise_coeff[1:] = betas[1:] / np.sqrt(1.0 - alpha_bar[1:])

    supportive_gamma = np.zeros_like(betas)
    supportive_gamma[1] = 0.2
    supportive_gamma[2:] = sigma[2:]
    supportive_sigma_hat = np.zeros_like(betas)
    supportive_sigma_hat[1:] = sigma[1:] - supportive_gamma[1:] / np.sqrt(alphas[1:])

    m = np.sqrt((1.0 - alpha_bar) / sqrt_alpha_bar)
    delta = (1.0 - alpha_bar) - m**2 * alpha_bar
    one_minus_m_ratio = (1.0 - m[1:]) / (1.0 - m[:-1])
    alpha_t_delta_t_1 = alphas[1:] * delta[:-1]
    delta_t_given_t_1 = delta[1:] - one_minus_m_ratio**2 * alpha_t_delta_t_1
    sqrt_alphas = np.sqrt(alphas[1:])

    c_xt = np.zeros_like(betas)
    c_xt[1:] = one_minus_m_ratio * delta[:-1] / delta[1:] * sqrt_alphas + (
        1.0 - m[:-1]) * (delta_t_given_t_1 / delta[1:]) * (1.0 / sqrt_alphas)
    c_yt = np.zeros_like(betas)
    c_yt[1:] = ((m[:-1] * delta[1:] - m[1:] * one_minus_m_ratio * alpha_t_delta_t_1)
                * sqrt_alpha_bar[:-1] / delta[1:])
    c_epst = np.zeros_like(betas)
    c_epst[1:] = ((1.0 - m[:-1]) * delta_t_given_t_1 / delta[1:]
                  * np.sqrt(1.0 - alpha_bar[1:]) / sqrt_alphas)
    delta_estimated = np.zeros_like(betas)
    delta_estimated[1:] = delta_t_given_t_1 * delta[:-1] / delta[1:]

    with np.errstate(invalid="ignore", divide="ignore"):
        sqrt_delta = np.sqrt(delta)
        sqrt_delta_est = np.sqrt(delta_estimated)
    return dict(
        betas=betas, alphas=alphas, alpha_bar=alpha_bar,
        sqrt_alpha_bar=sqrt_alpha_bar, sigma=sigma,
        predicted_noise_coeff=predicted_noise_coeff,
        supportive_gamma=supportive_gamma,
        supportive_sigma_hat=supportive_sigma_hat, m=m, sqrt_delta=sqrt_delta,
        c_xt=c_xt, c_yt=c_yt, c_epst=c_epst,
        sqrt_delta_estimated=sqrt_delta_est,
    )


def subsample_schedule(sched: DiffusionSchedule, num_steps: int):
    """A ``num_steps``-step schedule whose alpha_bar is an evenly spaced
    subsequence (ending at T) of the trained one.  Returns ``(schedule,
    t_map)``; ``t_map[k]`` is the original step of subsampled step k
    (index 0 pads with 0).  The denoiser still sees the trained noise levels."""
    T = sched.num_timesteps
    if not 1 <= num_steps <= T:
        raise ValueError(f"num_steps must be in [1, {T}]")
    ts = np.linspace(T / num_steps, T, num_steps)
    ts = np.unique(np.round(ts).astype(int))
    ab_full = sched.alpha_bar.detach().cpu().numpy().astype(np.float64)
    ab = np.concatenate([[1.0], ab_full[ts]])
    tables = _tables_from_alpha_bar(ab)
    sub = DiffusionSchedule(
        **{k: _cast(v, sched.betas.dtype).to(sched.betas.device)
           for k, v in tables.items()},
        num_timesteps=len(ts),
    )
    t_map = torch.from_numpy(np.concatenate([[0], ts]).astype(np.int32))
    return sub, t_map
