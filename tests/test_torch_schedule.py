"""Schedule tables and reverse transitions of the PyTorch port against the
JAX package.

The tables are built in float64 on the host and cast to float32 in both, so
they must be bit-equal.  The transitions do the same float32 arithmetic in
the same order on the same seeded inputs and noise; XLA may fuse or contract
an operation differently, so they are held to 1e-6 absolute.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.diffusion import schedule as jsched
from sddm_tpu.diffusion import transitions as jtr
from sddm_tpu_torch.diffusion import schedule as tsched
from sddm_tpu_torch.diffusion import transitions as ttr

FLAGSHIP = dict(schedule="linear", n_timestep=100, linear_start=1e-6, linear_end=1e-3)
TABLES = [f.name for f in dataclasses.fields(tsched.DiffusionSchedule)
          if f.name != "num_timesteps"]


def _pair(steps=None, **kw):
    j = jsched.DiffusionSchedule.create(**kw)
    t = tsched.DiffusionSchedule.create(**kw)
    if steps:
        j, jmap = jsched.subsample_schedule(j, steps)
        t, tmap = tsched.subsample_schedule(t, steps)
        np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    return j, t


@pytest.mark.parametrize("kw", [
    FLAGSHIP,
    dict(schedule="quad", n_timestep=50),
    dict(schedule="cosine", n_timestep=30),
])
@pytest.mark.parametrize("steps", [None, 12])
def test_tables_bit_equal(kw, steps):
    j, t = _pair(steps, **kw)
    assert t.num_timesteps == j.num_timesteps
    for name in TABLES:
        got = getattr(t, name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("name", ["linear", "quad", "cosine", "warmup10", "jsd", "const"])
def test_make_beta_schedule(name):
    np.testing.assert_array_equal(tsched.make_beta_schedule(name, 40),
                                  jsched.make_beta_schedule(name, 40))


def test_subsample_rejects_bad_step_counts():
    t = tsched.DiffusionSchedule.create(**FLAGSHIP)
    for steps in (0, 101):
        with pytest.raises(ValueError):
            tsched.subsample_schedule(t, steps)


def _arrays(seed, shape=(3, 1, 64)):
    rng = np.random.default_rng(seed)
    x_t = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    return x_t, pred, noise


@pytest.mark.parametrize("steps", [None, 12])
@pytest.mark.parametrize("t", [1, 2, 7, 12])
def test_p_transition(steps, t):
    j, s = _pair(steps, **FLAGSHIP)
    x_t, pred, noise = _arrays(t)
    want = jtr.p_transition(j, jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(pred),
                            None, jnp.asarray(noise))
    got = ttr.p_transition(s, torch.from_numpy(x_t), t, torch.from_numpy(pred),
                           noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("t", [1, 3, 12])
def test_p_transition_ddim(eta, t):
    j, s = _pair(12, **FLAGSHIP)
    x_t, pred, noise = _arrays(10 + t)
    want = jtr.p_transition_ddim(j, jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(pred),
                                 None, jnp.asarray(noise), eta=eta)
    got = ttr.p_transition_ddim(s, torch.from_numpy(x_t), t, torch.from_numpy(pred),
                                noise=torch.from_numpy(noise), eta=eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_get_x_T_noise_level_clip_and_gate():
    j, s = _pair(None, **FLAGSHIP)
    cond, _, noise = _arrays(5)
    want = jtr.get_x_T(j, jnp.asarray(cond), None, jnp.asarray(noise))
    got = ttr.get_x_T(s, torch.from_numpy(cond), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for t in (1, 50, 100):
        assert float(ttr.get_noise_level(s, t)) == float(jtr.get_noise_level(j, t))
        assert ttr._noise_gate(t) == float(jtr._noise_gate(jnp.asarray(t), jnp.float32))
    x = np.linspace(-2, 2, 41, dtype=np.float32)
    np.testing.assert_array_equal(ttr._clip(torch.from_numpy(x)).numpy(),
                                  np.asarray(jtr._clip(jnp.asarray(x))))


def test_generator_draws_are_seeded():
    _, s = _pair(None, **FLAGSHIP)
    cond = torch.zeros(2, 1, 32)
    a = ttr.get_x_T(s, cond, torch.Generator().manual_seed(4))
    b = ttr.get_x_T(s, cond, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.abs().sum() > 0
