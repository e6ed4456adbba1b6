"""SDDM: the training forward and the reverse samplers (counterpart of
``sddm_tpu/models/sddm.py``).

``forward`` samples the q process (``original``: ``q_stochastic``;
``conditional``: ``q_stochastic_conditional``, whose target is the combined
noise) and predicts its noise, the training objective.  The JAX package runs
the T-step reverse process as one ``lax.scan``; here it is a Python loop over
t = T..1 around the denoiser, with the per-step coefficients read from the
schedule tables.  Every reverse step of the JAX package is served:
``original`` (pure-noise start), ``condition_in`` (noised-condition start),
``sr3``, ``supportive`` (starting from the condition), ``conditional`` (the
conditional prior) and DDIM (``with_ddim``: ``ddim``, or
``ddim_conditional`` under the conditional q process), with the network
conditioned on ``sqrt_alpha_bar`` or on the trained ``time_step``.

``SDDM_with_SNREstimator`` segments the signals, estimates each segment's
SNR with a frozen estimator and drives the per-segment variable schedule
(``diffusion/variable.py``).

Dropout (``models/dropout.py``): ``forward`` runs the network inside a
``DropoutMasks``, whose masks a network in train mode with ``dropout > 0``
draws from ``generator`` after the q draws, as the JAX package splits its
key into ``(k_q, k_drop)``, or takes injected; the samplers and the frozen
estimator run inside ``deterministic()``, as the JAX package applies them
with ``deterministic=True``.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..diffusion import transitions as tr
from ..diffusion import variable as var
from ..diffusion.schedule import DiffusionSchedule, subsample_schedule
from ..ops.framing import Segmentor
from ..utils.profiling import span
from .dropout import DropoutMasks, deterministic

NOISE_CONDITIONS = ("sqrt_alpha_bar", "time_step")
P_TRANSITIONS = ("original", "supportive", "sr3", "conditional", "condition_in", "ddim")
Q_TRANSITIONS = ("original", "conditional")


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
        # the JAX package's settings: ddim_conditional comes only from with_ddim
        for value, allowed in ((noise_condition, NOISE_CONDITIONS),
                               (p_transition, P_TRANSITIONS),
                               (q_transition, Q_TRANSITIONS)):
            if value not in allowed:
                raise NotImplementedError(f"{value!r} is not one of {allowed}")
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

    def forward(self, target: torch.Tensor, condition: torch.Tensor,
                generator: torch.Generator | None = None, draws: tuple | None = None,
                dropout: DropoutMasks | None = None):
        """Sample the q process at ``target`` (clean ``[B, 1, T]``) and predict
        its noise from the noisy sample and ``condition``: ``(eps_hat, eps)``.
        Under the ``original`` q process the network sees the level under
        ``sqrt_alpha_bar`` conditioning and ``t + frac`` under ``time_step``,
        and ``draws`` is ``q_stochastic``'s ``(t, frac, eps)``; under the
        ``conditional`` one it sees the level whatever the conditioning, its
        target is the combined noise, and ``draws`` is
        ``q_stochastic_conditional``'s ``(t, eps)``.  Without ``draws`` they
        come from ``generator``.  The network's dropout masks come from
        ``dropout``, by default drawn from ``generator`` after the q draws."""
        sched = self.diffusion.to(target.device)
        if self.q_transition == "conditional":
            x_t, noise, cond_in = tr.q_stochastic_conditional(sched, target, condition,
                                                              generator, draws)
        else:
            x_t, noise, level, t_cont = tr.q_stochastic(sched, target, generator, draws)
            cond_in = level if self.noise_condition == "sqrt_alpha_bar" else t_cont
        with dropout if dropout is not None else DropoutMasks(generator):
            return self.network(condition, x_t, cond_in), noise

    def with_ddim(self, eta: float = 0.0) -> "SDDM":
        """A copy whose reverse step is the DDIM update on the same
        eps-predictor, the conditional DDIM update (``ddim_conditional``) under
        the conditional q process; the first keeps the noised-condition
        start, the second the conditional prior."""
        new = copy.copy(self)
        new.p_transition = "ddim_conditional" if self.q_transition == "conditional" else "ddim"
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
        if self.p_transition in ("conditional", "ddim_conditional"):
            return tr.get_x_T_conditional(sched, condition, generator, noise)
        if self.p_transition in ("condition_in", "ddim"):
            return tr.get_x_T(sched, condition, generator, noise)
        if self.p_transition == "supportive":
            return condition
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
        if self.p_transition in ("original", "condition_in"):
            return tr.p_transition(sched, x_t, t, predicted, generator, noise)
        if self.p_transition == "sr3":
            return tr.p_transition_sr3(sched, x_t, t, predicted, generator, noise)
        if self.p_transition == "ddim":
            return tr.p_transition_ddim(sched, x_t, t, predicted, generator, noise,
                                        eta=self.ddim_eta)
        if self.p_transition == "ddim_conditional":
            return tr.p_transition_ddim_conditional(sched, x_t, t, predicted, condition,
                                                    generator, noise, eta=self.ddim_eta)
        if self.p_transition == "supportive":
            return tr.p_transition_supportive(sched, x_t, t, predicted, condition, generator,
                                              noise)
        return tr.p_transition_conditional(sched, x_t, t, predicted, condition, generator,
                                           noise)

    @torch.no_grad()
    @deterministic()
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
        are the same either way.

        Spans (``utils/profiling``, while recording): ``sampler.call`` over
        the call, inside it ``sampler.prepare`` (x_T and the network's hooks)
        and ``sampler.step`` (attr ``t``) for each reverse step."""
        with span("sampler.call"):
            condition = self._featurize(condition)
            sched = self.diffusion.to(condition.device)
            xT_noise, step_noises = noise_stream if noise_stream is not None else (None, None)
            with span("sampler.prepare"):
                x = self._x_T(sched, condition, generator, xT_noise)
                prepare = getattr(self.network, "prepare", None)
                prep = prepare() if prepare is not None else None
                prepare_condition = getattr(self.network, "prepare_condition", None)
                cond_ctx = (prepare_condition(prep, condition)
                            if prepare_condition is not None else None)
            traj = []
            for i, t in enumerate(range(self.num_timesteps, 0, -1)):
                with span("sampler.step", t=t):
                    nz = step_noises[i] if step_noises is not None else None
                    x = self._reverse_step(sched, condition, x, t, generator, nz, prep, cond_ctx)
                    if return_trajectory:
                        traj.append(x)
            if return_trajectory:
                return x, torch.stack(traj)
            return x

    def _featurize(self, condition: torch.Tensor) -> torch.Tensor:
        """The condition as the network takes it (the waveform samplers': as given)."""
        return condition

    def draw_noise_stream(self, shape, generator: torch.Generator | None, device=None,
                          dtype=torch.float32, cut=None) -> tuple:
        """The draws :meth:`infer` makes from ``generator`` for a condition of
        ``shape`` (the waveform samplers, whose x_T has the condition's shape),
        as its ``noise_stream``: x_T's, None where the ``supportive`` start
        draws none, then one a step, None where DDIM at eta 0 draws none, in
        ``infer``'s order and shapes, each passed through ``cut`` (a rank's
        rows, say).  With ``cut`` taking rows ``r``, ``infer(condition[r],
        noise_stream=...)`` gives rows ``r`` of ``infer(condition, generator)``
        up to the network's rounding at the other row count, and leaves
        ``generator`` where that call leaves it.  A step's draw is made when the
        sampler asks for it, so one step's batch is held at a time."""
        def draw():
            noise = torch.randn(shape, generator=generator, device=device, dtype=dtype)
            return noise if cut is None else cut(noise)

        xT = None if self.p_transition == "supportive" else draw()
        if self.p_transition in ("ddim", "ddim_conditional") and self.ddim_eta == 0.0:
            return xT, None
        return xT, _StepDraws(self.num_timesteps, draw)

    def sample_interval(self) -> int:
        """The stride of the intermediate samples ``infer --continuous``
        writes: ``1 | (T // 100)``."""
        return 1 | (self.num_timesteps // 100)


class _StepDraws:
    """The step draws of :meth:`SDDM.draw_noise_stream`: ``[i]`` makes step
    ``i``'s draw, in order, as ``SDDM.infer`` asks for each once."""

    def __init__(self, n: int, draw):
        self.n, self.draw, self.next = n, draw, 0

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> torch.Tensor:
        if i != self.next or i >= self.n:
            raise IndexError(f"step draws are made in order, {self.n} of them: asked for {i}, "
                             f"next is {self.next}")
        self.next += 1
        return self.draw()


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

    def forward(self, target, condition, generator=None, draws=None, dropout=None):
        """``SDDM.forward`` on the featurized condition: with ``feature_fn``
        set, raw audio ``[B, 1, T]`` becomes its spectrogram first."""
        return super().forward(target, self._featurize(condition), generator, draws, dropout)

    def _x_T(self, sched, condition, generator=None, noise=None) -> torch.Tensor:
        if noise is not None:
            return noise
        n = self.hop_samples * condition.shape[-1]
        return torch.randn((condition.shape[0], 1, n), generator=generator,
                           device=condition.device)


class SDDM_with_SNREstimator:
    """Segment the signal, estimate each segment's SNR with a FROZEN estimator,
    and drive the per-segment variable schedule.  Only ``network`` trains: the
    estimator runs without autograd and its parameters do not require
    gradients (the JAX package stops its gradient; its optimizer sees zeros),
    and its dropout never acts, whatever its mode (``deterministic()``).

    ``p_transition`` ``"condition_in"`` is accepted, as the shipped configs
    set it, and the sampler runs the variable ``original`` step with the
    noised-condition start whatever it says, as the JAX package does."""

    def __init__(self, diffusion_timesteps: int, network: nn.Module, snr_estimator: nn.Module,
                 segmentor: Segmentor, snr_estimate_scale: float = 100.0,
                 noise_condition: str = "sqrt_alpha_bar", p_transition: str = "original",
                 q_transition: str = "original"):
        if noise_condition != "sqrt_alpha_bar":
            raise NotImplementedError(noise_condition)
        if p_transition not in ("original", "condition_in"):
            raise NotImplementedError(p_transition)
        if q_transition != "original":
            raise NotImplementedError(q_transition)
        self.num_timesteps = diffusion_timesteps
        self.network = network
        self.snr_estimator = snr_estimator.eval().requires_grad_(False)
        self.segmentor = segmentor
        self.snr_estimate_scale = snr_estimate_scale

    def tables(self, condition_seg: torch.Tensor) -> var.VariableSchedule:
        """The estimator's SNR of each segment of ``condition_seg`` and the
        variable schedule of it."""
        with torch.no_grad(), deterministic():
            snr = self.snr_estimator(condition_seg)
        return var.variable_tables(snr, self.num_timesteps, self.snr_estimate_scale)

    def forward(self, target: torch.Tensor, condition: torch.Tensor,
                generator: torch.Generator | None = None, draws: tuple | None = None,
                dropout: DropoutMasks | None = None):
        """``(eps_hat, eps)`` on the segmented ``[B, 1, N, L]`` tensors of the
        clean ``target`` and ``condition`` ``[B, 1, T]``; ``draws`` is
        ``var.q_stochastic``'s ``(t, eps)``; the network's dropout masks come
        from ``dropout``, by default from ``generator`` after the q draws."""
        target_seg = self.segmentor(target)
        condition_seg = self.segmentor(condition)
        vsched = self.tables(condition_seg)
        x_t, noise, level, _t = var.q_stochastic(vsched, target_seg, generator, draws)
        with dropout if dropout is not None else DropoutMasks(generator):
            return self.network(condition_seg, x_t, level, **self._prepare_network()), noise

    def _prepare_network(self) -> dict:
        """The network's call arguments for one forward or one ``infer``: a
        network with ``prepare`` (the packed engines) packs its weights here,
        once, outside the sampler's steps."""
        prepare = getattr(self.network, "prepare", None)
        return {} if prepare is None else {"prep": prepare()}

    @torch.no_grad()
    @deterministic()
    def infer(self, condition: torch.Tensor, generator: torch.Generator | None = None,
              noise_stream=None) -> torch.Tensor:
        """The T-step reverse process on the segmented condition, then the
        cross-fade overlap-add back to ``[B, 1, T]``.  ``noise_stream`` is
        ``(xT_noise, step_noises)``, ``step_noises[i]`` the draw of step
        t = T - i, in place of every draw from ``generator``."""
        with span("sampler.call"):
            xT_noise, step_noises = noise_stream if noise_stream is not None else (None, None)
            with span("sampler.prepare"):
                condition_seg = self.segmentor(condition)
                vsched = self.tables(condition_seg)
                x = var.get_x_T(vsched, condition_seg, generator, xT_noise)
                prep = self._prepare_network()
            for i, t in enumerate(range(self.num_timesteps, 0, -1)):
                with span("sampler.step", t=t):
                    predicted = self.network(condition_seg, x, var.get_noise_level(vsched, t),
                                             **prep)
                    nz = step_noises[i] if step_noises is not None else None
                    x = var.p_transition(vsched, x, t, predicted, generator, nz)
            return self.segmentor.overlap_add(x)
