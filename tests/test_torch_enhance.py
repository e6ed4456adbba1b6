"""The PyTorch port's sampler and serving API against the JAX package.

Sampler: a tiny UNetModified2 with the same weights (through the bridge)
runs ``SDDM.infer`` in both frameworks under one shared noise stream, for
ancestral full-T, 3 subsampled steps, DDIM eta=0, and 3 steps of DDIM
eta=0.5, which draws noise at every step but the last.  Each step adds the
float32 difference of one forward (see test_torch_unet.py) and the steps'
coefficients are below 1, so the chain is held to rtol 1e-4, atol 1e-4.

Enhancer: the chunking, static row padding and trim are compared with the
JAX ``Enhancer`` around the same deterministic stand-in model, and
``load_enhancer`` is driven end to end on a tiny checkpoint written by the
JAX package: through the packed engine, its default, against JAX's
``load_enhancer`` under shared noise; with ``packed=False``; and with a NaN
weight, which fails the packed engine's canary and falls back to the plain
network.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from sddm_tpu.enhance import Enhancer as JaxEnhancer
from sddm_tpu.models import SDDM as JaxSDDM
from sddm_tpu.models import UNetModified2 as JaxUNet
from sddm_tpu.train.checkpoints import save_checkpoint
from sddm_tpu_torch import enhance as tenh
from sddm_tpu_torch.compat import state_dict_from_jax
from sddm_tpu_torch.diffusion import DiffusionSchedule
from sddm_tpu_torch.models import SDDM, PackedUNetModified2, UNetModified2

NS = 72
T = 8
NET = dict(inner_channel=8, norm_groups=4, channel_mults=[1, 2], res_blocks=1,
           segment_len=16, segment_stride=8)
SCHED = dict(schedule="linear", n_timestep=T, linear_start=1e-4, linear_end=0.05)
CONFIG = {
    "num_samples": NS,
    "arch": {"type": "SDDM", "args": {"p_transition": "condition_in"}},
    "diffusion": {"type": "GaussianDiffusion", "args": SCHED},
    "network": {"type": "UNetModified2", "args": dict(NET, in_channel=2, out_channel=1,
                                                       dropout=0)},
    "packed": True,
}


@pytest.fixture(scope="module")
def nets():
    jnet = JaxUNet(num_samples=NS, **NET)
    params = jax.tree_util.tree_map(np.asarray, JaxSDDM(JaxSchedule.create(**SCHED), jnet)
                                    .init(jax.random.PRNGKey(0), (1, 1, NS)))
    tnet = UNetModified2(num_samples=NS, **NET).eval()
    tnet.load_state_dict(state_dict_from_jax(params, NET["channel_mults"], 1, 8))
    return jnet, tnet, params


def _models(nets, **arch):
    jnet, tnet, params = nets
    return (JaxSDDM(JaxSchedule.create(**SCHED), jnet, **arch),
            SDDM(DiffusionSchedule.create(**SCHED), tnet, **arch), params)


@pytest.fixture(scope="module")
def pair(nets):
    return _models(nets, p_transition="condition_in")


def _fewstep(m, steps, ddim):
    if ddim:
        m = m.with_ddim()
    return m.with_sampling_steps(steps) if steps else m


@pytest.mark.parametrize("steps,ddim,arch", [
    (0, False, dict(p_transition="condition_in")),
    (3, False, dict(p_transition="condition_in")),
    (0, True, dict(p_transition="condition_in")),
    (3, True, dict(p_transition="condition_in")),
    (3, False, dict(p_transition="ddim", ddim_eta=0.5)),
])
def test_sampler_matches_jax_under_shared_noise(nets, steps, ddim, arch):
    jmodel, tmodel, params = _models(nets, **arch)
    jmodel, tmodel = _fewstep(jmodel, steps, ddim), _fewstep(tmodel, steps, ddim)
    assert jmodel.num_timesteps == tmodel.num_timesteps == (steps or T)
    rng = np.random.default_rng(steps + 10 * ddim)
    cond = rng.uniform(-0.5, 0.5, (3, 1, NS)).astype(np.float32)
    xT = rng.standard_normal(cond.shape).astype(np.float32)
    step_noises = rng.standard_normal((tmodel.num_timesteps,) + cond.shape).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.infer)(
        params, jax.random.PRNGKey(0), jnp.asarray(cond),
        noise_stream=(jnp.asarray(xT), jnp.asarray(step_noises))))
    got = tmodel.infer(torch.from_numpy(cond),
                       noise_stream=(torch.from_numpy(xT), torch.from_numpy(step_noises)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [
    dict(p_transition="sr3"),
    dict(p_transition="supportive"),
    dict(p_transition="condition_in", q_transition="conditional"),
])
def test_sddm_refuses_settings_it_does_not_serve(nets, arch):
    with pytest.raises(NotImplementedError, match="not ported"):
        SDDM(DiffusionSchedule.create(**SCHED), nets[1], **arch)


class _Recorder:
    """Deterministic stand-in sampler: y = 2 * condition + 1, shapes recorded."""

    def __init__(self):
        self.shapes = []
        self.network = torch.nn.Linear(1, 1)

    def infer(self, condition, *args, **kwargs):
        self.shapes.append(tuple(condition.shape))
        return 2 * condition + 1


def test_enhancer_chunk_pad_trim_match_jax():
    lens = [10, NS, NS + 1, 5 * NS - 3]
    rng = np.random.default_rng(1)
    audios = [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in lens]
    rec = _Recorder()
    got = tenh.Enhancer(rec, NS, batch_rows=3).enhance_batch(audios)
    jrec = _Recorder()
    jrec.infer = lambda params, key, cond: 2 * cond + 1
    want = JaxEnhancer(jrec, None, NS, batch_rows=3).enhance_batch(audios)
    assert [g.shape for g in got] == [w.shape for w in want] == [(n,) for n in lens]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # 1 + 1 + 2 + 5 = 9 rows -> three calls of exactly batch_rows rows
    assert rec.shapes == [(3, 1, NS)] * 3


def test_load_enhancer_serves_a_jax_checkpoint(tmp_path, pair):
    jmodel, _, params = pair
    path = tmp_path / "model_best.ckpt"
    save_checkpoint(path, arch="SDDM", epoch=1, params=params, opt_state={},
                    monitor_best=0.0, config=CONFIG)
    enh = tenh.load_enhancer(path, json.loads(json.dumps(CONFIG)), batch_rows=2,
                             steps=3, ddim=True, device="cpu")
    assert enh.device == torch.device("cpu")
    cond = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    xT = np.zeros_like(cond)
    want = np.asarray(jmodel.with_ddim().with_sampling_steps(3).infer(
        params, jax.random.PRNGKey(0), jnp.asarray(cond),
        noise_stream=(jnp.asarray(xT), None)))
    got = enh.model.infer(torch.from_numpy(cond), noise_stream=(torch.from_numpy(xT), None))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    out = enh.enhance_batch([cond[0, 0, :50], cond[1, 0]])
    assert [o.shape for o in out] == [(50,), (NS,)]
    assert all(np.isfinite(o).all() for o in out)


def test_load_enhancer_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenh.load_enhancer("unused.ckpt", CONFIG)


def _save(path, params, config):
    save_checkpoint(path, arch="SDDM", epoch=1, params=params, opt_state={},
                    monitor_best=0.0, config=config)
    return path


def test_load_enhancer_serves_the_packed_engine_as_jax_does(tmp_path, nets, monkeypatch):
    """``"packed": true`` serves PackedUNetModified2, as JAX ``load_enhancer``
    serves its packed engine.  JAX gets the config without the key: with it,
    its ``build_network`` returns the packed training twin, which
    ``load_enhancer`` cannot serve (``sddm_tpu/enhance.py:236-237``)."""
    from sddm_tpu.enhance import load_enhancer as jax_load_enhancer
    from sddm_tpu.models.unet_packed import PackedUNetModified2 as JaxPacked

    monkeypatch.setenv("SDDM_COMPILE_CACHE", os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                                            str(tmp_path / "jax_cache")))
    params = nets[2]
    path = _save(tmp_path / "model_best.ckpt", params, CONFIG)
    enh = tenh.load_enhancer(path, json.loads(json.dumps(CONFIG)), batch_rows=2, steps=3,
                             device="cpu")
    assert isinstance(enh.model.network, PackedUNetModified2) and enh.engine_fallback is None
    assert enh.validate()
    jax_config = {k: v for k, v in CONFIG.items() if k != "packed"}
    jenh = jax_load_enhancer(path, jax_config, batch_rows=2, steps=3)
    assert isinstance(jenh.model.network, JaxPacked)
    rng = np.random.default_rng(4)
    cond = rng.uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    xT = rng.standard_normal(cond.shape).astype(np.float32)
    step_noises = rng.standard_normal((3,) + cond.shape).astype(np.float32)
    want = np.asarray(jax.jit(jenh.model.infer)(
        jenh.params, jax.random.PRNGKey(0), jnp.asarray(cond),
        noise_stream=(jnp.asarray(xT), jnp.asarray(step_noises))))
    got = enh.model.infer(torch.from_numpy(cond),
                          noise_stream=(torch.from_numpy(xT), torch.from_numpy(step_noises)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_load_enhancer_packed_false_serves_the_plain_network(tmp_path, nets):
    path = _save(tmp_path / "model_best.ckpt", nets[2], CONFIG)
    enh = tenh.load_enhancer(path, CONFIG, batch_rows=2, steps=2, packed=False, device="cpu")
    assert type(enh.model.network) is UNetModified2 and enh.engine_fallback is None
    assert enh.model.num_timesteps == 2


def test_load_enhancer_falls_back_when_the_canary_fails(tmp_path, nets, caplog):
    """A NaN weight makes the packed engine's canary output non-finite: the
    loader warns and serves the plain network, as JAX's loader does."""
    params = jax.tree_util.tree_map(np.array, nets[2])
    params["params"]["Block_0"]["Conv_0"]["bias"][0] = np.nan
    path = _save(tmp_path / "model_best.ckpt", params, CONFIG)
    with caplog.at_level(logging.WARNING, logger="enhance"):
        enh = tenh.load_enhancer(path, CONFIG, batch_rows=2, steps=2, device="cpu")
    assert type(enh.model.network) is UNetModified2 and enh.engine_fallback == "canary"
    assert any("canary" in r.getMessage() for r in caplog.records)
    assert not enh.validate()


def test_load_enhancer_takes_the_level_structure_from_the_module(tmp_path, monkeypatch):
    """A config that leaves ``inner_channel``, ``channel_mults`` and
    ``res_blocks`` to the module's defaults (32, 1-5, 3) loads, as in JAX,
    and serves JAX's function: the port's packed engine against JAX's
    ``load_enhancer`` on the same config without ``"packed"``, under shared
    noise, at the sampler tolerance."""
    from sddm_tpu.enhance import load_enhancer as jax_load_enhancer

    monkeypatch.setenv("SDDM_COMPILE_CACHE", os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                                            str(tmp_path / "jax_cache")))
    ns = 528  # 32 frames of 32 samples: five levels of 2x downsampling
    args = dict(in_channel=2, out_channel=1, norm_groups=4, dropout=0, segment_len=32,
                segment_stride=16)
    config = {**CONFIG, "num_samples": ns, "network": {"type": "UNetModified2", "args": args}}
    jax_config = {k: v for k, v in config.items() if k != "packed"}
    jnet = JaxUNet(num_samples=ns, **args)
    params = jax.tree_util.tree_map(np.asarray, JaxSDDM(JaxSchedule.create(**SCHED), jnet)
                                    .init(jax.random.PRNGKey(1), (1, 1, ns)))
    path = _save(tmp_path / "model_best.ckpt", params, config)
    enh = tenh.load_enhancer(path, json.loads(json.dumps(config)), batch_rows=1, steps=2,
                             device="cpu")
    net = enh.model.network.net
    assert isinstance(enh.model.network, PackedUNetModified2)
    assert (net.inner_channel, net.channel_mults, net.res_blocks) == (32, (1, 2, 3, 4, 5), 3)
    jenh = jax_load_enhancer(path, jax_config, batch_rows=1, steps=2, packed=False)
    rng = np.random.default_rng(7)
    cond = rng.uniform(-0.5, 0.5, (1, 1, ns)).astype(np.float32)
    xT = rng.standard_normal(cond.shape).astype(np.float32)
    step_noises = rng.standard_normal((2,) + cond.shape).astype(np.float32)
    want = np.asarray(jax.jit(jenh.model.infer)(
        jenh.params, jax.random.PRNGKey(0), jnp.asarray(cond),
        noise_stream=(jnp.asarray(xT), jnp.asarray(step_noises))))
    got = enh.model.infer(torch.from_numpy(cond),
                          noise_stream=(torch.from_numpy(xT), torch.from_numpy(step_noises)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_load_enhancer_runs_the_canary_once_and_serves_by_its_verdict(tmp_path, nets,
                                                                     monkeypatch):
    """The packed engine is served only after one canary call says so; the
    loader has no option that skips it."""
    path = _save(tmp_path / "model_best.ckpt", nets[2], CONFIG)
    calls, verdict = [], [True]
    monkeypatch.setattr(tenh.Enhancer, "validate",
                        lambda self: calls.append(self) or verdict[0])
    enh = tenh.load_enhancer(path, CONFIG, batch_rows=2, steps=2, device="cpu")
    assert isinstance(enh.model.network, PackedUNetModified2) and enh.engine_fallback is None
    assert calls == [enh]
    verdict[0] = False
    enh = tenh.load_enhancer(path, CONFIG, batch_rows=2, steps=2, device="cpu")
    assert len(calls) == 2 and type(enh.model.network) is UNetModified2
    assert enh.engine_fallback == "canary"
