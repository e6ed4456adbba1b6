"""GroupNorm + SiLU of the PyTorch port (``sddm_tpu_torch.ops.gn_silu``)
against the JAX package: the Pallas kernel in interpret mode, its jnp
reference, and flax ``GroupNorm`` + swish, on the same seeded numpy inputs.

Tolerances: float32 atol 1e-5 (the sums are taken in another order, so the
statistics differ in the last bits); bfloat16 one bf16 ulp of the result
(2**-7 relative) plus 1e-5 absolute for outputs near zero, where a last-bit
difference of the f32 mean shows before rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sddm_tpu.experimental.pallas_groupnorm_swish import (
    group_norm_swish,
    group_norm_swish_reference,
)
from sddm_tpu_torch.ops.gn_silu import _check, gn_silu, gn_silu_reference

# (B, H, W, C, G): channels per group 1, 2, 3, 5, 10
SHAPES = [
    (2, 8, 4, 8, 8),
    (2, 8, 4, 16, 8),
    (1, 4, 8, 12, 4),
    (2, 4, 4, 40, 8),
    (1, 8, 4, 40, 4),
]
BF16_ULP = 2.0**-7


def _inputs(shape, seed):
    b, h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32) * 2.0 + 0.5
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, dtype=torch.float32):
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    y = gn_silu(x.to(dtype).contiguous(), torch.from_numpy(scale),
                torch.from_numpy(bias), groups)
    assert y.dtype == dtype
    return y.float().numpy().transpose(0, 2, 3, 1)


def _flax(x, scale, bias, groups):
    gn = nn.GroupNorm(num_groups=groups, epsilon=1e-5, dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    return jax.nn.silu(gn.apply(params, x)).astype(x.dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_matches_jax_reference_and_flax(shape):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    g = shape[-1]
    got = _port(x, scale, bias, g)
    ref = np.asarray(group_norm_swish_reference(jnp.asarray(x), jnp.asarray(scale),
                                                jnp.asarray(bias), num_groups=g))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_flax(jnp.asarray(x), scale, bias, g)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[3] == s[4]])
def test_f32_matches_pallas_interpret(shape):
    """The Pallas body covers C == G only (it falls back otherwise)."""
    x, scale, bias = _inputs(shape, seed=7)
    g = shape[-1]
    pallas = group_norm_swish(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              num_groups=g, interpret=True)
    np.testing.assert_allclose(_port(x, scale, bias, g), np.asarray(pallas),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_within_one_ulp_of_jax(shape):
    x, scale, bias = _inputs(shape, seed=100 + sum(shape))
    g = shape[-1]
    x_bf = jnp.asarray(x, jnp.bfloat16)
    x_rounded = np.asarray(x_bf.astype(jnp.float32))  # the same bf16 input
    got = _port(x_rounded, scale, bias, g, dtype=torch.bfloat16)
    for ref in (group_norm_swish_reference(x_bf, jnp.asarray(scale), jnp.asarray(bias),
                                           num_groups=g),
                _flax(x_bf, scale, bias, g)):
        assert ref.dtype == jnp.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-5)


def test_near_constant_group_stays_finite():
    """E[x^2] - E[x]^2 rounds below zero on a near-constant group; the clamp
    keeps rsqrt finite (the round-3 NaN of the unclamped Pallas body)."""
    rng = np.random.default_rng(3)
    b, c, h, w, g = 2, 16, 8, 8, 16
    x = (1000.0 + 1e-3 * rng.standard_normal((b, c, h, w))).astype(np.float32)
    xt = torch.from_numpy(x)
    xg = xt.reshape(b, g, -1)
    unclamped = (xg * xg).mean(-1) - xg.mean(-1) ** 2
    assert (unclamped < 0).any(), "the case must exercise the clamp"
    y = gn_silu(xt, torch.ones(c), torch.zeros(c), g)
    assert torch.isfinite(y).all()
    flax_y = _flax(jnp.asarray(x.transpose(0, 2, 3, 1)), np.ones(c, np.float32),
                   np.zeros(c, np.float32), g)
    assert np.isfinite(np.asarray(flax_y)).all()


def test_cpu_tensor_takes_reference_without_launch():
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    w, b = torch.ones(8), torch.zeros(8)
    before = gn_silu.launches
    assert torch.equal(gn_silu(x, w, b, 4), gn_silu_reference(x, w, b, 4))
    assert gn_silu.launches == before


@pytest.mark.parametrize("bad", [
    dict(x=torch.zeros(2, 8, 16)),                          # not NCHW
    dict(x=torch.zeros(2, 8, 4, 4, dtype=torch.float16)),   # dtype
    dict(x=torch.zeros(2, 4, 4, 8).permute(0, 3, 1, 2)),    # not contiguous
    dict(groups=3),                                          # C % G
    dict(w=torch.ones(8, dtype=torch.bfloat16)),             # weight dtype
    dict(b=torch.zeros(4)),                                  # bias shape
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(x=torch.zeros(2, 8, 4, 4), w=torch.ones(8), b=torch.zeros(8), groups=4)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        _check(args["x"], args["w"], args["b"], args["groups"])


def test_non_cuda_device_raises():
    x = torch.zeros(2, 8, 4, 4, device="meta")
    with pytest.raises(ValueError):
        gn_silu(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), 4)
