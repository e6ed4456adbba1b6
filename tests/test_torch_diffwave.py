"""The PyTorch port's DiffWave slice against the JAX package: the weight
bridge, ``DiffusionEmbedding``, ``SpectrogramUpsampler``, ``DiffWave``,
``FusedDiffWave``, the ``SDDM_spectrogram`` sampler under a shared noise
stream, the config builders, ``load_specmodel``, and one forward of the
committed trained checkpoint.

Tolerances (float32 on the CPU): the weight bridge is exact.  A forward
sums its convolutions in another order than XLA, so the modules are held to
2e-5 absolute and relative, as the JAX package holds its fused engine to the
flax network (tests/test_diffwave_fused.py); so is the full-width trained
checkpoint (30 layers, 513 bins), which reads about 1e-6 on outputs of
scale 3.5.  The sampler carries each step's
difference through the chain and is held to 5e-4, the JAX package's own
bound between its two engines' samplers.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.compat.zoo_import import import_diffwave_state
from sddm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from sddm_tpu.models import DiffWave as JaxDiffWave
from sddm_tpu.models import FusedDiffWave as JaxFused
from sddm_tpu.models import SDDM_spectrogram as JaxSpecSDDM
from sddm_tpu.models.diffwave import DiffusionEmbedding as JaxEmbedding
from sddm_tpu.models.diffwave import SpectrogramUpsampler as JaxUpsampler
from sddm_tpu.ops.spectrogram import make_feature_fn as jax_feature_fn
from sddm_tpu.train.checkpoints import save_checkpoint
from sddm_tpu_torch import load_specmodel
from sddm_tpu_torch import specmodel as tspecmodel
from sddm_tpu_torch.cli import build_arch, build_diffusion, build_network
from sddm_tpu_torch.compat import diffwave_state_dict_from_jax
from sddm_tpu_torch.diffusion import DiffusionSchedule
from sddm_tpu_torch.models import SDDM, DiffWave, FusedDiffWave, SDDM_spectrogram
from sddm_tpu_torch.train.checkpoints import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent
RUN = ROOT / "artifacts" / "round5" / "diffwave"
B, FREQ, FRAMES, C, L, CYCLE = 2, 16, 2, 8, 7, 3
T = 256 * FRAMES
NET = dict(freq_bins=FREQ, residual_channels=C, residual_layers=L, dilation_cycle_length=CYCLE)
SCHED = dict(schedule="linear", n_timestep=5, linear_start=1e-4, linear_end=0.02)
CONFIG = {
    "sample_rate": 16000,
    "num_samples": -1,
    "spectrogram": {"window_length": 30, "hop_samples": 256, "stft_bins": FREQ},
    "arch": {"type": "SDDM_spectrogram", "args": {"noise_condition": "time_step"}},
    "diffusion": {"type": "GaussianDiffusion", "args": SCHED},
    "network": {"type": "DiffWave", "args": dict(residual_channels=C, residual_layers=L,
                                                  dilation_cycle_length=CYCLE)},
    "test_data_loader": {"type": "WaveGradDataLoader", "args": {"hop_samples": 256}},
}


@pytest.fixture(scope="module")
def params():
    """Flax DiffWave params with every leaf moved off its init (the head's
    output conv starts at zero, the biases too), as numpy."""
    net = JaxDiffWave(**NET)
    spec = jnp.zeros((1, FREQ, FRAMES))
    p = net.init(jax.random.PRNGKey(0), spec, jnp.zeros((1, 1, T)), jnp.ones((1,)))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), p)


@pytest.fixture(scope="module")
def nets(params):
    tnet = DiffWave(**NET).eval()
    tnet.load_state_dict(diffwave_state_dict_from_jax(params, residual_layers=L))
    return JaxDiffWave(**NET), tnet


def _inputs(seed, t_value=3.0):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (B, FREQ, FRAMES)).astype(np.float32)
    x_t = rng.standard_normal((B, 1, T)).astype(np.float32)
    t = np.full((B, 1, 1), t_value, np.float32)
    return spec, x_t, t


def _same_tree(a, b, path="root"):
    assert sorted(a) == sorted(b), path
    for k in b:
        if isinstance(b[k], dict):
            _same_tree(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


def test_weight_bridge_round_trips_exactly(params, nets):
    state = {k: v.numpy() for k, v in nets[1].state_dict().items()}
    assert set(state) == set(diffwave_state_dict_from_jax(params, L))
    _same_tree(import_diffwave_state(state, residual_layers=L, prefix=""), params)


@pytest.mark.parametrize("t_value", [1.0, 57.0, 199.0])
def test_diffusion_embedding_matches_flax(params, nets, t_value):
    t = np.full((B,), t_value, np.float32)
    want = np.asarray(JaxEmbedding().apply(
        {"params": params["params"]["DiffusionEmbedding_0"]}, jnp.asarray(t)))
    with torch.no_grad():
        got = nets[1].diffusion_embedding(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_spectrogram_upsampler_matches_flax(params, nets):
    spec = _inputs(1)[0]
    want = np.asarray(JaxUpsampler().apply(
        {"params": params["params"]["SpectrogramUpsampler_0"]}, jnp.asarray(spec)))
    with torch.no_grad():
        got = nets[1].spectrogram_upsampler(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == (B, FREQ, T)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_forward_matches_jax(params, nets, engine):
    jnet, tnet = nets
    spec, x_t, t = _inputs(2, t_value=4.0)
    want = np.asarray(jnet.apply(params, *map(jnp.asarray, (spec, x_t, t))))
    if engine == "fused":
        want_fused = np.asarray(JaxFused(jnet, use_kernel=False).apply(
            params, *map(jnp.asarray, (spec, x_t, t))))
        np.testing.assert_allclose(want_fused, want, rtol=2e-5, atol=2e-5)
        tnet = FusedDiffWave(tnet)
    with torch.no_grad():
        got = tnet(*map(torch.from_numpy, (spec, x_t, t))).numpy()
    assert got.shape == want.shape == (B, 1, T)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _models(nets, engine):
    jnet, tnet = nets
    jmodel = JaxSpecSDDM(JaxSchedule.create(**SCHED), jnet, hop_samples=256,
                         noise_condition="time_step")
    tnet = FusedDiffWave(tnet) if engine == "fused" else tnet
    tmodel = SDDM_spectrogram(DiffusionSchedule.create(**SCHED), tnet, hop_samples=256,
                              noise_condition="time_step")
    return jmodel, tmodel


@pytest.mark.parametrize("steps,ddim,engine", [
    (0, False, "plain"), (0, False, "fused"), (3, False, "fused"), (0, True, "plain"),
    (3, True, "fused"),
])
def test_sampler_matches_jax_under_shared_noise(params, nets, steps, ddim, engine):
    jmodel, tmodel = _models(nets, engine)
    if ddim:
        jmodel, tmodel = jmodel.with_ddim(), tmodel.with_ddim()
    if steps:
        jmodel, tmodel = jmodel.with_sampling_steps(steps), tmodel.with_sampling_steps(steps)
        # time_step conditioning feeds the trained step, not the subsampled one
        np.testing.assert_array_equal(tmodel._t_map.numpy(), np.asarray(jmodel._t_map))
    assert jmodel.num_timesteps == tmodel.num_timesteps == (steps or SCHED["n_timestep"])
    rng = np.random.default_rng(steps + 10 * ddim)
    spec = rng.uniform(0, 1, (B, FREQ, FRAMES)).astype(np.float32)
    xT = rng.standard_normal((B, 1, T)).astype(np.float32)
    noises = rng.standard_normal((tmodel.num_timesteps, B, 1, T)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.infer)(
        params, jax.random.PRNGKey(0), jnp.asarray(spec),
        noise_stream=(jnp.asarray(xT), jnp.asarray(noises))))
    got = tmodel.infer(torch.from_numpy(spec),
                       noise_stream=(torch.from_numpy(xT), torch.from_numpy(noises)))
    assert got.shape == want.shape == (B, 1, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_sampler_draws_its_start_from_the_generator(nets):
    _, tmodel = _models(nets, "fused")
    spec = torch.rand(B, FREQ, FRAMES, generator=torch.Generator().manual_seed(0))
    runs = [tmodel.infer(spec, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert runs[0].shape == (B, 1, T) and torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_sddm_defaults_construct_and_refuse_unported_settings(nets):
    sched = DiffusionSchedule.create(**SCHED)
    model = SDDM(sched, nets[1])
    assert (model.p_transition, model.noise_condition) == ("original", "sqrt_alpha_bar")
    for arch in (dict(p_transition="sr3"), dict(p_transition="supportive"),
                 dict(p_transition="conditional"), dict(p_transition="ddim_conditional"),
                 dict(q_transition="conditional")):
        with pytest.raises(NotImplementedError, match="not ported"):
            SDDM(sched, nets[1], **arch)


def test_cli_builds_fused_engine_for_packed():
    net = build_network(CONFIG)
    assert type(net) is DiffWave and net.dtype == torch.float32
    assert len(net.residual_layers) == L
    assert net.residual_layers[0].conditioner_projection.in_channels == FREQ
    packed = build_network(dict(CONFIG, packed=True, dtype="bfloat16"))
    assert isinstance(packed, FusedDiffWave) and packed.net.dtype == torch.bfloat16
    mel = dict(CONFIG, spectrogram={}, mel_spectrogram={"n_mels": 80})
    assert build_network(mel).residual_layers[0].conditioner_projection.in_channels == 80
    model = build_arch(CONFIG, build_diffusion(CONFIG), net, hop_samples=256)
    assert isinstance(model, SDDM_spectrogram) and model.noise_condition == "time_step"
    with pytest.raises(KeyError, match="not ported"):
        build_network(dict(CONFIG, network={"type": "WaveGrad", "args": {}}))


@pytest.mark.parametrize("packed", [False, True])
def test_load_specmodel_serves_a_jax_checkpoint(tmp_path, params, nets, packed):
    config = dict(CONFIG, packed=packed)
    path = tmp_path / "model_best.ckpt"
    save_checkpoint(path, arch="SDDM_spectrogram", epoch=1, params=params, opt_state={},
                    monitor_best=0.0, config=config)
    model = load_specmodel(path, json.loads(json.dumps(config)), steps=3, ddim=True,
                           device="cpu")
    assert isinstance(model.network, FusedDiffWave) is packed
    assert model.num_timesteps == 3 and model.hop_samples == 256
    jmodel = JaxSpecSDDM(JaxSchedule.create(**SCHED), nets[0], hop_samples=256,
                         noise_condition="time_step",
                         feature_fn=jax_feature_fn("spec", 30, 256))
    jmodel = jmodel.with_ddim().with_sampling_steps(3)
    rng = np.random.default_rng(4)
    audio = (0.2 * rng.standard_normal((B, 1, T))).astype(np.float32)  # raw-audio condition
    xT = rng.standard_normal((B, 1, T)).astype(np.float32)
    want = np.asarray(jmodel.infer(params, jax.random.PRNGKey(0), jnp.asarray(audio),
                                   noise_stream=(jnp.asarray(xT), None)))
    got = model.infer(torch.from_numpy(audio), noise_stream=(torch.from_numpy(xT), None))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_load_specmodel_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspecmodel.load_specmodel("unused.ckpt", CONFIG)


def test_trained_checkpoint_forward_matches_jax():
    config = json.loads((RUN / "config.json").read_text())
    params = load_checkpoint(RUN / "model_best.ckpt")["params"]
    freq = config["spectrogram"]["stft_bins"]
    args = dict(config["network"]["args"], freq_bins=freq)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((1, 1, 512))).astype(np.float32)
    spec = np.array(jax_feature_fn("spec", 1024, 256)(jnp.asarray(audio)))  # [1, 513, 2]
    x_t = rng.standard_normal((1, 1, 512)).astype(np.float32)
    t = np.full((1, 1, 1), 57.0, np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jax.jit(JaxFused(JaxDiffWave(**args), use_kernel=False).apply)(
        jparams, *map(jnp.asarray, (spec, x_t, t))))

    tnet = DiffWave(**args).eval()
    tnet.load_state_dict(diffwave_state_dict_from_jax(params, args["residual_layers"]))
    with torch.no_grad():
        for net in (tnet, FusedDiffWave(tnet)):
            got = net(*map(torch.from_numpy, (spec, x_t, t))).numpy()
            assert got.shape == want.shape == (1, 1, 512) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
