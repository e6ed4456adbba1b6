"""SDDM reverse sampler (counterpart of ``sddm_tpu/models/sddm.py``, serving only).

The JAX package runs the T-step reverse process as one ``lax.scan``; here it
is a Python loop over t = T..1 around the denoiser, with the per-step
coefficients read from the schedule tables.  The port serves the flagship
recipe: ``condition_in`` (noised-condition start, ancestral step) or DDIM,
conditioned on ``sqrt_alpha_bar``.  Training (``forward``), ``time_step``
conditioning and the other transitions wait for the slices whose networks
use them.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..diffusion import transitions as tr
from ..diffusion.schedule import DiffusionSchedule, subsample_schedule

NOISE_CONDITIONS = ("sqrt_alpha_bar",)
P_TRANSITIONS = ("condition_in", "ddim")
Q_TRANSITIONS = ("original",)


class SDDM:
    """Conditional diffusion speech-enhancement model around a denoiser module.
    The defaults are the JAX package's; ``p_transition`` must be
    ``condition_in`` or ``ddim``, the values the port serves."""

    def __init__(
        self,
        diffusion: DiffusionSchedule,
        network: nn.Module,
        noise_condition: str = "sqrt_alpha_bar",
        p_transition: str = "original",
        q_transition: str = "original",
        ddim_eta: float = 0.0,
    ):
        for value, allowed in ((noise_condition, NOISE_CONDITIONS),
                               (p_transition, P_TRANSITIONS),
                               (q_transition, Q_TRANSITIONS)):
            if value not in allowed:
                raise NotImplementedError(
                    f"{value!r} is not ported; the port serves {allowed}")
        self.diffusion = diffusion
        self.network = network
        self.num_timesteps = diffusion.num_timesteps
        self.noise_condition = noise_condition
        self.p_transition = p_transition
        self.q_transition = q_transition
        self.ddim_eta = float(ddim_eta)

    def with_ddim(self, eta: float = 0.0) -> "SDDM":
        """A copy whose reverse step is the DDIM update on the same
        eps-predictor; it keeps the noised-condition start."""
        new = copy.copy(self)
        new.p_transition = "ddim"
        new.ddim_eta = float(eta)
        return new

    def with_sampling_steps(self, num_steps: int) -> "SDDM":
        """A copy whose sampler runs ``num_steps`` steps over a subsequence of
        the trained schedule; the denoiser still sees the trained levels."""
        new = copy.copy(self)
        new.diffusion, _ = subsample_schedule(self.diffusion, num_steps)
        new.num_timesteps = new.diffusion.num_timesteps
        return new

    def _reverse_step(self, sched, condition, x_t, t: int, generator=None,
                      noise=None) -> torch.Tensor:
        ones = torch.ones(condition.shape[:1] + (1,) * (condition.dim() - 1),
                          dtype=condition.dtype, device=condition.device)
        predicted = self.network(condition, x_t, tr.get_noise_level(sched, t) * ones)
        if self.p_transition == "ddim":
            return tr.p_transition_ddim(sched, x_t, t, predicted, generator, noise,
                                        eta=self.ddim_eta)
        return tr.p_transition(sched, x_t, t, predicted, generator, noise)

    @torch.no_grad()
    def infer(self, condition: torch.Tensor, generator: torch.Generator | None = None,
              noise_stream=None) -> torch.Tensor:
        """Run the reverse process from x_T to x_0 on ``condition`` ``[B, 1, T]``.

        ``noise_stream`` is ``(xT_noise, step_noises)`` with ``step_noises[i]``
        the N(0, 1) draw for step t = T - i; it replaces every draw from
        ``generator`` so that the chain can be compared elementwise with the
        JAX sampler fed the same stream."""
        sched = self.diffusion.to(condition.device)
        xT_noise, step_noises = noise_stream if noise_stream is not None else (None, None)
        x = tr.get_x_T(sched, condition, generator, xT_noise)
        for i, t in enumerate(range(self.num_timesteps, 0, -1)):
            nz = step_noises[i] if step_noises is not None else None
            x = self._reverse_step(sched, condition, x, t, generator, nz)
        return x
