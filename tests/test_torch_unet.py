"""UNetModified2 of the PyTorch port against the flax network, through the
weight bridge.

The bridge must be exact both ways: flax params -> the port's state_dict ->
``sddm_tpu.compat.import_unet_modified2_state`` gives back the same arrays.
The forward runs in float32 on the CPU in both frameworks; convolution sums
are taken in other orders, so outputs are held to rtol 1e-3, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.compat import import_unet_modified2_state
from sddm_tpu.models import UNetModified2 as JaxUNet
from sddm_tpu_torch.compat import state_dict_from_jax
from sddm_tpu_torch.models import UNetModified2
from sddm_tpu_torch.models.blocks import GroupNormSiLU

NUM_SAMPLES = 208  # 12 frames of 32 at stride 16
INNER = 8
GROUPS = 4
MULTS = (1, 2)
RES_BLOCKS = 1


def _nets(res_blocks=RES_BLOCKS):
    kw = dict(num_samples=NUM_SAMPLES, inner_channel=INNER, norm_groups=GROUPS,
              channel_mults=MULTS, res_blocks=res_blocks, segment_len=32,
              segment_stride=16)
    jnet = JaxUNet(**kw)
    zeros = jnp.zeros((1, 1, NUM_SAMPLES))
    params = jnet.init(jax.random.PRNGKey(res_blocks), zeros, zeros, jnp.ones((1, 1, 1)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tnet = UNetModified2(**kw).eval()
    tnet.load_state_dict(state_dict_from_jax(params, MULTS, res_blocks, INNER))
    return jnet, tnet, params


@pytest.mark.parametrize("res_blocks", [1, 2])
def test_bridge_round_trip(res_blocks):
    _, tnet, params = _nets(res_blocks)
    back = import_unet_modified2_state(
        {k: v.numpy() for k, v in tnet.state_dict().items()},
        channel_mults=MULTS, res_blocks=res_blocks, inner_channel=INNER, prefix="")
    leaves_a, tree_a = jax.tree_util.tree_flatten(params)
    leaves_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(b), a)
    n_params = sum(p.numel() for p in tnet.parameters())
    assert n_params == sum(a.size for a in leaves_a)


def test_gn_sites_per_forward():
    """Every GroupNorm of the network is a fused GroupNorm+SiLU site:
    2 per ResnetBlock plus the final Block (33 at the flagship config)."""
    tnet = UNetModified2(num_samples=16448, res_blocks=1)
    n_sites = sum(isinstance(m, GroupNormSiLU) for m in tnet.modules())
    assert n_sites == 33
    assert sum(p.numel() for p in tnet.parameters()) == 5_229_793


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_flax(seed):
    jnet, tnet, params = _nets()
    rng = np.random.default_rng(seed)
    cond = rng.uniform(-0.5, 0.5, (2, 1, NUM_SAMPLES)).astype(np.float32)
    x_t = rng.standard_normal((2, 1, NUM_SAMPLES)).astype(np.float32)
    level = rng.uniform(0.1, 1.0, (2, 1, 1)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(cond), jnp.asarray(x_t),
                                 jnp.asarray(level)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(cond), torch.from_numpy(x_t),
                   torch.from_numpy(level)).numpy()
    assert got.shape == want.shape == (2, 1, NUM_SAMPLES)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_bf16_compute_keeps_f32_params_and_io():
    _, tnet, _ = _nets()
    tnet.dtype = torch.bfloat16
    x = torch.zeros(1, 1, NUM_SAMPLES)
    with torch.no_grad():
        out = tnet(x, x, torch.ones(1, 1, 1))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
