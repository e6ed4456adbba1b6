"""SDDM reverse samplers (counterpart of ``sddm_tpu/models/sddm.py``, serving only).

The JAX package runs the T-step reverse process as one ``lax.scan``; here it
is a Python loop over t = T..1 around the denoiser, with the per-step
coefficients read from the schedule tables.  The port serves the settings
its configs select: the ``original`` (pure-noise start) and
``condition_in`` (noised-condition start) ancestral steps, or DDIM, with the
network conditioned on ``sqrt_alpha_bar`` or on the trained ``time_step``.
Training (``forward``) and the other transitions wait for the slices whose
configs use them.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..diffusion import transitions as tr
from ..diffusion.schedule import DiffusionSchedule, subsample_schedule

NOISE_CONDITIONS = ("sqrt_alpha_bar", "time_step")
P_TRANSITIONS = ("original", "condition_in", "ddim")
Q_TRANSITIONS = ("original",)


class SDDM:
    """Conditional diffusion speech-enhancement model around a denoiser module,
    with the JAX package's defaults."""

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
        # set by with_sampling_steps: subsampled step -> the trained step,
        # which time_step conditioning feeds the network
        self._t_map = None

    def with_ddim(self, eta: float = 0.0) -> "SDDM":
        """A copy whose reverse step is the DDIM update on the same
        eps-predictor; it keeps this model's start (``_x_T``)."""
        new = copy.copy(self)
        new.p_transition = "ddim"
        new.ddim_eta = float(eta)
        return new

    def with_sampling_steps(self, num_steps: int) -> "SDDM":
        """A copy whose sampler runs ``num_steps`` steps over a subsequence of
        the trained schedule; the denoiser still sees the trained levels and,
        under ``time_step`` conditioning, the trained steps."""
        new = copy.copy(self)
        new.diffusion, new._t_map = subsample_schedule(self.diffusion, num_steps)
        new.num_timesteps = new.diffusion.num_timesteps
        return new

    def _x_T(self, sched, condition, generator=None, noise=None) -> torch.Tensor:
        if self.p_transition in ("condition_in", "ddim"):
            return tr.get_x_T(sched, condition, generator, noise)
        if noise is not None:
            return noise
        return torch.randn(condition.shape, generator=generator, device=condition.device,
                           dtype=condition.dtype)

    def _reverse_step(self, sched, condition, x_t, t: int, generator=None, noise=None,
                      prep=None, cond_ctx=None) -> torch.Tensor:
        # the network sees sqrt_alpha_bar[t], or the trained step as a float;
        # ``cond_ctx`` (from its prepare_condition hook) replaces the condition
        # in the network call only, and ``prep`` (from its prepare hook) is
        # passed on when the network has one
        shape = condition.shape[:1] + (1,) * (condition.dim() - 1)
        ones = torch.ones(shape, dtype=x_t.dtype, device=x_t.device)
        if self.noise_condition == "sqrt_alpha_bar":
            level = tr.get_noise_level(sched, t) * ones
        else:
            level = float(self._t_map[t] if self._t_map is not None else t) * ones
        extra = {} if prep is None else {"prep": prep}
        predicted = self.network(condition if cond_ctx is None else cond_ctx, x_t, level,
                                 **extra)
        if self.p_transition == "ddim":
            return tr.p_transition_ddim(sched, x_t, t, predicted, generator, noise,
                                        eta=self.ddim_eta)
        return tr.p_transition(sched, x_t, t, predicted, generator, noise)

    @torch.no_grad()
    def infer(self, condition: torch.Tensor, generator: torch.Generator | None = None,
              noise_stream=None, *, return_trajectory: bool = False):
        """Run the reverse process from x_T to x_0 on ``condition``.

        ``noise_stream`` is ``(xT_noise, step_noises)`` with ``step_noises[i]``
        the N(0, 1) draw for step t = T - i; it replaces every draw from
        ``generator`` so that the chain can be compared elementwise with the
        JAX sampler fed the same stream.  A network with ``prepare`` and
        ``prepare_condition`` hooks runs them once here, outside the loop.
        ``return_trajectory=True`` returns ``(x_0, traj)`` with ``traj`` every
        step's state stacked, ``[T, B, ...]`` (``traj[-1]`` is x_0); the draws
        are the same either way."""
        sched = self.diffusion.to(condition.device)
        xT_noise, step_noises = noise_stream if noise_stream is not None else (None, None)
        x = self._x_T(sched, condition, generator, xT_noise)
        prepare = getattr(self.network, "prepare", None)
        prep = prepare() if prepare is not None else None
        prepare_condition = getattr(self.network, "prepare_condition", None)
        cond_ctx = prepare_condition(prep, condition) if prepare_condition is not None else None
        traj = []
        for i, t in enumerate(range(self.num_timesteps, 0, -1)):
            nz = step_noises[i] if step_noises is not None else None
            x = self._reverse_step(sched, condition, x, t, generator, nz, prep, cond_ctx)
            if return_trajectory:
                traj.append(x)
        if return_trajectory:
            return x, torch.stack(traj)
        return x

    def sample_interval(self) -> int:
        """The stride of the intermediate samples ``infer --continuous``
        writes: ``1 | (T // 100)``."""
        return 1 | (self.num_timesteps // 100)


class SDDM_spectrogram(SDDM):
    """Vocoder-style SDDM: the condition is a spectrogram ``[B, freq, frames]``
    and sampling starts from pure noise of length ``hop_samples * frames``.
    With ``feature_fn`` set, the condition may be raw audio ``[B, 1, T]``,
    turned into the spectrogram first."""

    def __init__(self, diffusion: DiffusionSchedule, network: nn.Module, hop_samples: int,
                 noise_condition: str = "sqrt_alpha_bar", feature_fn=None):
        super().__init__(diffusion, network, noise_condition)
        self.hop_samples = hop_samples
        self.feature_fn = feature_fn

    def _featurize(self, condition: torch.Tensor) -> torch.Tensor:
        if self.feature_fn is not None and condition.dim() == 3 and condition.shape[1] == 1:
            return self.feature_fn(condition)
        return condition

    def infer(self, condition, generator=None, noise_stream=None, *,
              return_trajectory: bool = False):
        return super().infer(self._featurize(condition), generator, noise_stream,
                             return_trajectory=return_trajectory)

    def _x_T(self, sched, condition, generator=None, noise=None) -> torch.Tensor:
        if noise is not None:
            return noise
        n = self.hop_samples * condition.shape[-1]
        return torch.randn((condition.shape[0], 1, n), generator=generator,
                           device=condition.device)
