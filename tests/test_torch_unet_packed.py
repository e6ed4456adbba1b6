"""The packed (space-to-depth) engine of the PyTorch port
(``sddm_tpu_torch.models.PackedUNetModified2``) against the JAX package's
(``sddm_tpu/models/unet_packed.py``) and against the port's plain
UNetModified2, on the tiny network of ``tests/test_packed_model.py``.

- ``pack()`` of a JAX-initialised tree, carried by the weight bridge, gives
  JAX's packed tree leaf by leaf (conv kernels HWIO -> OIHW); the packing
  functions are copies, so exactly.
- The packed forward computes the plain network's function at every
  ``packed_levels``, and JAX's packed forward, in float32 within rtol 2e-4,
  atol 2e-5, as the JAX package holds its own engine.
- ``SDDM.infer`` through the packed engine matches JAX's packed sampler
  under one shared noise stream, at ancestral-2 and DDIM-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.diffusion import DiffusionSchedule as JaxSchedule
from sddm_tpu.models import SDDM as JaxSDDM
from sddm_tpu.models import UNetModified2 as JaxUNet
from sddm_tpu.models.unet_packed import PackedUNetModified2 as JaxPacked
from sddm_tpu_torch.compat import state_dict_from_jax
from sddm_tpu_torch.diffusion import DiffusionSchedule
from sddm_tpu_torch.models import SDDM, PackedUNetModified2, UNetModified2
from sddm_tpu_torch.models.unet_packed import _GN

NS = 72  # 8 frames of 16 at stride 8
NET = dict(inner_channel=8, norm_groups=4, channel_mults=(1, 2, 3), res_blocks=1,
           segment_len=16, segment_stride=8)
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def exact_f32():
    """TF32 off and full-precision f32 matmuls for every comparison here."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


@pytest.fixture(scope="module")
def setup():
    jnet = JaxUNet(num_samples=NS, **NET)
    rng = np.random.RandomState(0)
    cond = rng.uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    x_t = rng.uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    lvl = np.full((2, 1, 1), 0.7, np.float32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), cond, x_t, lvl)
    params = jax.tree_util.tree_map(np.asarray, params)
    tnet = UNetModified2(num_samples=NS, **NET).eval()
    tnet.load_state_dict(state_dict_from_jax(params, NET["channel_mults"], 1, 8))
    return jnet, tnet, params, cond, x_t, lvl


def _leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, node


def test_pack_equals_jax_leaf_by_leaf(setup):
    jnet, tnet, params, *_ = setup
    want = JaxPacked(jnet).pack(params)
    got = PackedUNetModified2(tnet).pack()
    assert sorted(got) == sorted(want)
    n_conv = n_gn = 0
    for path, leaf in _leaves(got):
        if path[-2] == "gn":
            continue
        ref = want
        for k in path:
            ref = ref[k]
        ref = np.asarray(ref)
        if ref.ndim == 4:  # HWIO -> OIHW
            ref = ref.transpose(3, 2, 0, 1)
            n_conv += 1
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), ref, err_msg="/".join(path))
    for path, gn in _leaves(want):
        if not isinstance(gn, type(want["Block_0"]["gn"])):
            continue
        mine = got
        for k in path:
            mine = mine[k]
        np.testing.assert_array_equal(mine["scale"].numpy(), np.asarray(gn.scale))
        np.testing.assert_array_equal(mine["bias"].numpy(), np.asarray(gn.bias))
        group_of = np.asarray(gn.group_of) if gn.onehot is not None else \
            np.arange(gn.scale.shape[0]) // (gn.scale.shape[0] // gn.groups)
        np.testing.assert_array_equal(mine["group_of"].numpy(), group_of)
        assert mine["offset"] == gn.offset
        if gn.onehot is not None:
            assert mine["count"] == gn.count
        n_gn += 1
    # 10 res blocks (2 GN each, 8 with a res conv) + the head; 3 down, 3 up, conv_in
    assert (n_conv, n_gn) == (10 * 2 + 8 + 1 + 3 + 3 + 1, 10 * 2 + 1)


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_forward_matches_the_plain_network(setup, levels):
    _, tnet, _, cond, x_t, lvl = setup
    eng = PackedUNetModified2(tnet, packed_levels=levels).eval()
    args = [torch.from_numpy(a) for a in (cond, x_t, lvl)]
    with torch.no_grad():
        got, ref = eng(*args), tnet(*args)
    assert got.shape == ref.shape == (2, 1, NS)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_forward_matches_jax_packed_and_runs_every_site_through_gn(setup):
    jnet, tnet, params, cond, x_t, lvl = setup
    jeng = JaxPacked(jnet)
    want = np.asarray(jax.jit(jeng.apply)(jeng.pack(params), cond, x_t, lvl))
    eng = PackedUNetModified2(tnet).eval()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(m))
             for m in eng.modules() if isinstance(m, _GN)]
    with torch.no_grad():
        got = eng(*(torch.from_numpy(a) for a in (cond, x_t, lvl)))
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert len(seen) == 21 and len(set(map(id, seen))) == 21  # 2 per res block + head
    assert sum(m.offset for m in seen) == 8  # Block_1 of each packed res block


@pytest.mark.parametrize("ddim", [False, True])
def test_sampler_matches_jax_packed_under_shared_noise(setup, ddim):
    jnet, tnet, params, *_ = setup
    sched = dict(schedule="linear", n_timestep=6, linear_start=1e-6, linear_end=1e-3)
    jeng = JaxPacked(jnet)
    jmodel = JaxSDDM(JaxSchedule.create(**sched), jeng, p_transition="condition_in")
    tmodel = SDDM(DiffusionSchedule.create(**sched), PackedUNetModified2(tnet).eval(),
                  p_transition="condition_in")
    if ddim:
        jmodel, tmodel = jmodel.with_ddim(), tmodel.with_ddim()
    jmodel, tmodel = jmodel.with_sampling_steps(2), tmodel.with_sampling_steps(2)
    rng = np.random.default_rng(5 + ddim)
    cond = rng.uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    xT = rng.standard_normal(cond.shape).astype(np.float32)
    step_noises = rng.standard_normal((2,) + cond.shape).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.infer)(
        jeng.pack(params), jax.random.PRNGKey(0), jnp.asarray(cond),
        noise_stream=(jnp.asarray(xT), jnp.asarray(step_noises))))
    got = tmodel.infer(torch.from_numpy(cond),
                       noise_stream=(torch.from_numpy(xT), torch.from_numpy(step_noises)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_refuses_dropout():
    net = UNetModified2(num_samples=NS, dropout=0.1, **NET)
    with pytest.raises(ValueError, match="dropout"):
        PackedUNetModified2(net)
