"""What the plain references share: the arithmetic precision of a run, the
diffusion tables, the two reverse samplers the cells serve, the training
objective and the AMSGrad optimizer.  Plain PyTorch and NumPy, written from
the published equations (Ho et al. 2020; Song et al. 2021, DDIM; Chen et
al. 2021, WaveGrad's continuous noise level; Reddi et al. 2018 as optax's
``scale_by_amsgrad`` computes it).  It imports nothing of the measured
program.

A reference runs in float32 with TF32 off (:func:`strict_float32`).  Its
control, the step below the bfloat16 the configurations state, is fp8:
:class:`Precision` with ``fp8=True`` rounds the input and the weight of
every convolution and matrix product to float8 e4m3 (a scale per tensor,
its largest magnitude at 448) and computes the rest in float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matrix products and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor, back in
    float32; the rounding passes gradients through unchanged."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


class Precision:
    """The arithmetic of one reference run: float32, or fp8 at the inputs
    of every convolution and matrix product (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.fp8 else x

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self.q(x), self.q(w), b, **kw)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)

    def conv_transpose2d(self, x, w, b=None, **kw):
        return F.conv_transpose2d(self.q(x), self.q(w), b, **kw)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)


def compute_dtype(config: dict) -> torch.dtype:
    """The compute dtype a configuration states (``"dtype"``; float32 without)."""
    return {"bfloat16": torch.bfloat16}.get(config.get("dtype"), torch.float32)


def encoding_argument(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a * b``, the argument of a sinusoidal encoding, formed as a model
    that computes in ``dtype`` forms it: both factors and the product
    rounded to ``dtype``, in float32 from there.  Arguments reach 1e4 rad and
    more, where a bf16 ulp is tens of radians: the sine of another rounding
    is another encoding, not a rounding of the same one, so the reference
    forms the argument as the configuration states and computes everything
    after it in float32.  The fp8 control forms it the same way: its lower
    precision is that of the convolutions and matrix products."""
    if dtype == torch.float32:
        return a * b
    return (a.to(dtype) * b.to(dtype)).to(torch.float32)


# ---- diffusion tables -----------------------------------------------------------
def linear_tables(n_timestep: int, linear_start: float, linear_end: float) -> dict:
    """beta, alpha, alpha_bar, sqrt(alpha_bar) and the ancestral sigma of a
    linear schedule, each ``[T + 1]`` (index 0: no noise), in float64."""
    betas = np.zeros(n_timestep + 1)
    betas[1:] = np.linspace(linear_start, linear_end, n_timestep)
    return tables_of(np.cumprod(1.0 - betas))


def tables_of(alpha_bar: np.ndarray) -> dict:
    """The tables of a schedule given by its ``[T + 1]`` alpha_bar."""
    betas = np.zeros_like(alpha_bar)
    betas[1:] = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
    sigma = np.zeros_like(alpha_bar)
    sigma[1:] = np.sqrt((1.0 - alpha_bar[:-1]) / (1.0 - alpha_bar[1:]) * betas[1:])
    return {"betas": betas, "alphas": 1.0 - betas, "alpha_bar": alpha_bar,
            "sqrt_alpha_bar": np.sqrt(alpha_bar), "sigma": sigma}


def subsampled(tables: dict, num_steps: int):
    """A ``num_steps``-step schedule on the evenly spaced trained steps
    ``round(linspace(T / n, T, n))``: its tables and the trained step of
    each of its steps (index 0: 0)."""
    T = len(tables["alpha_bar"]) - 1
    ts = np.unique(np.round(np.linspace(T / num_steps, T, num_steps)).astype(int))
    ab = np.concatenate([[1.0], tables["alpha_bar"][ts]])
    return tables_of(ab), np.concatenate([[0], ts])


def _f32(v) -> float:
    return float(np.float32(v))


def ancestral_step(tab: dict, x: torch.Tensor, t: int, eps_hat: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """x_{t-1} = (x_t - beta_t / sqrt(1 - alpha_bar_t) eps_hat) / sqrt(alpha_t)
    + [t > 1] sigma_t z, clipped to [-1, 1]."""
    coeff = _f32(tab["betas"][t] / np.sqrt(1.0 - tab["alpha_bar"][t]))
    mean = (x - coeff * eps_hat) / _f32(np.sqrt(tab["alphas"][t]))
    if t > 1:
        mean = mean + _f32(tab["sigma"][t]) * noise
    return mean.clamp(-1.0, 1.0)


def ddim_step(tab: dict, x: torch.Tensor, t: int, eps_hat: torch.Tensor) -> torch.Tensor:
    """The deterministic DDIM update (eta 0), clipped to [-1, 1]."""
    ab_t, ab_p = tab["alpha_bar"][t], tab["alpha_bar"][t - 1]
    x0_hat = (x - _f32(np.sqrt(1.0 - ab_t)) * eps_hat) / _f32(np.sqrt(ab_t))
    return (_f32(np.sqrt(ab_p)) * x0_hat + _f32(np.sqrt(1.0 - ab_p)) * eps_hat).clamp(-1.0, 1.0)


def noised_condition_start(tab: dict, condition: torch.Tensor, noise: torch.Tensor):
    """x_T = sqrt(alpha_bar_T) y + sqrt(1 - alpha_bar_T) z."""
    level = _f32(tab["sqrt_alpha_bar"][-1])
    return level * condition + _f32(np.sqrt(1.0 - np.float32(level) ** 2)) * noise


# ---- training -------------------------------------------------------------------
def continuous_level(tab: dict, t: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """WaveGrad's level: between sqrt(alpha_bar) at t - 1 and at t, by ``frac``."""
    sab = torch.as_tensor(tab["sqrt_alpha_bar"], dtype=torch.float32, device=frac.device)
    lo, hi = sab[t - 1], sab[t]
    return lo + frac * (hi - lo)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


class AmsGrad:
    """optax ``amsgrad`` then the learning rate: the bias-corrected second
    moment's running maximum, ``p -= lr mu_hat / (sqrt(nu_max) + eps)``."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.count += 1
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(self.count))
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            torch.maximum(self.nu_max[k], self.nu[k] / c2, out=self.nu_max[k])
            p.sub_(self.lr * (self.mu[k] / c1) / (self.nu_max[k].sqrt() + self.eps))
