"""The NHWC GroupNorm + SiLU (+ offset mask) of the PyTorch port
(``sddm_tpu_torch.ops.gn_silu.gn_silu_nhwc``) against the JAX package's
packed engine: ``_GN`` + ``jax.nn.silu`` + ``_offset_mask_np``
(``sddm_tpu/models/unet_packed.py``), and the Pallas kernel
``sddm_tpu/experimental/pallas_gn_silu.py::gn_silu`` in interpret mode, on
the same seeded numpy inputs.

Tolerance: float32, 1e-5 absolute and relative: the sums are taken in
another order, so the statistics differ in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.experimental.pallas_gn_silu import gn_silu as pallas_gn_silu
from sddm_tpu.models.unet_packed import _GN, _offset_mask_np, _packed_gn_plan
from sddm_tpu_torch.models.unet_packed import _packed_gn_plan as port_plan
from sddm_tpu_torch.ops.gn_silu import (
    _check_nhwc,
    gn_silu_nhwc,
    gn_silu_nhwc_reference,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(h, w, sections, groups, offset, seed, packed=True):
    """Seeded inputs and the JAX chain's output for one site."""
    rng = np.random.default_rng(seed)
    c = sum(sections)
    c4 = 4 * c if packed else c
    x = rng.standard_normal((2, h, w, c4)).astype(np.float32) * 1.5 + 0.3
    if offset:
        x = x * _offset_mask_np(h, w, c)
    sc = rng.standard_normal(c4).astype(np.float32)
    bi = rng.standard_normal(c4).astype(np.float32)
    if packed:
        plan = _packed_gn_plan(groups, sections)
        gn = _GN(jnp.asarray(sc), jnp.asarray(bi), groups, plan, offset=offset)
        group_of, count = plan[1], plan[3]
    else:
        gn = _GN(jnp.asarray(sc), jnp.asarray(bi), groups)
        plan, count = None, c // groups
        group_of = np.arange(c) // count
    want = jax.nn.silu(gn(jnp.asarray(x)))
    if offset:
        want = want * jnp.asarray(_offset_mask_np(h, w, c), want.dtype)
    return x, sc, bi, group_of, count, plan, np.asarray(want)


def _port(x, sc, bi, group_of, groups, count, offset, dtype=torch.float32):
    y = gn_silu_nhwc(torch.from_numpy(x).to(dtype), torch.from_numpy(sc), torch.from_numpy(bi),
                     torch.from_numpy(np.asarray(group_of, np.int32)), groups, count, offset)
    assert y.dtype == dtype
    return y.float().numpy()


# tests/test_pallas.py::TestGnSilu's cases: (H, W, c, groups, offset)
PALLAS_CASES = [(9, 5, 8, 4, True), (17, 9, 16, 8, False), (13, 7, 8, 4, True)]


@pytest.mark.parametrize("h,w,c,groups,offset", PALLAS_CASES)
def test_matches_jax_gn_chain_and_pallas_interpret(h, w, c, groups, offset):
    x, sc, bi, group_of, count, plan, want = _case(h, w, (c,), groups, offset, seed=h)
    got = _port(x, sc, bi, group_of, groups, count, offset)
    np.testing.assert_allclose(got, want, **TOL)
    pallas = pallas_gn_silu(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi),
                            jnp.asarray(plan[2]), count=count, offset=offset, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("h,w,sections,groups,offset", [
    (6, 4, (8, 4), 4, False),    # a decoder concat: group map not contiguous
    (7, 5, (4, 12), 4, False),
    (5, 3, (8,), 2, True),
])
def test_concatenated_plans_match_jax(h, w, sections, groups, offset):
    x, sc, bi, group_of, count, plan, want = _case(h, w, sections, groups, offset, seed=7)
    ch_orig, port_group_of, port_count = port_plan(groups, sections)
    np.testing.assert_array_equal(port_group_of, plan[1])
    np.testing.assert_array_equal(ch_orig, plan[0])
    assert port_count == plan[3]
    np.testing.assert_allclose(_port(x, sc, bi, group_of, groups, count, offset), want, **TOL)


@pytest.mark.parametrize("h,w,c,groups", [(4, 2, 20, 4), (4, 2, 40, 8)])
def test_identity_plan_matches_jax_unpacked_gn(h, w, c, groups):
    """The unpacked NHWC sites of the bottom level: group c // (C / G)."""
    x, sc, bi, group_of, count, _, want = _case(h, w, (c,), groups, False, seed=c,
                                                packed=False)
    np.testing.assert_allclose(_port(x, sc, bi, group_of, groups, count, False), want, **TOL)


def test_bf16_rounds_once():
    x, sc, bi, group_of, count, _, _ = _case(9, 5, (8,), 4, True, seed=11)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = _port(xb.float().numpy(), sc, bi, group_of, 4, count, True, dtype=torch.bfloat16)
    want = _port(xb.float().numpy(), sc, bi, group_of, 4, count, True)
    np.testing.assert_array_equal(got, torch.from_numpy(want).to(torch.bfloat16).float().numpy())


def test_near_constant_group_stays_finite():
    """E[x^2] - E[x]^2 rounds below zero on a near-constant group; the clamp
    keeps rsqrt finite (the round-3 NaN of the packed engine)."""
    rng = np.random.default_rng(3)
    b, h, w, c, groups = 2, 8, 6, 8, 4
    x = (1000.0 + 1e-3 * rng.standard_normal((b, h, w, 4 * c))).astype(np.float32)
    ch_orig, group_of, count = port_plan(groups, (c,))
    xt = torch.from_numpy(x)
    s1 = torch.zeros(b, groups).index_add_(1, torch.from_numpy(group_of), xt.sum((1, 2)))
    s2 = torch.zeros(b, groups).index_add_(1, torch.from_numpy(group_of), (xt * xt).sum((1, 2)))
    n = h * w * count
    assert ((s2 / n - (s1 / n) ** 2) < 0).any(), "the case must exercise the clamp"
    y = _port(x, np.ones(4 * c, np.float32), np.zeros(4 * c, np.float32), group_of, groups,
              count, False)
    assert np.isfinite(y).all()


def test_cpu_tensor_takes_reference_without_launch():
    x = torch.randn(2, 5, 3, 16, generator=torch.Generator().manual_seed(0))
    args = (torch.ones(16), torch.zeros(16), torch.arange(16, dtype=torch.int32) // 4, 4, 4)
    before = gn_silu_nhwc.launches
    assert torch.equal(gn_silu_nhwc(x, *args, offset=True),
                       gn_silu_nhwc_reference(x, *args, offset=True))
    assert gn_silu_nhwc.launches == before


@pytest.mark.parametrize("bad", [
    dict(x=torch.zeros(2, 8, 16)),                              # not [B, H, W, C4]
    dict(x=torch.zeros(2, 4, 4, 8, dtype=torch.float16)),       # dtype
    dict(x=torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1)),        # not contiguous
    dict(groups=9),                                              # G > C4
    dict(g=torch.zeros(8, dtype=torch.int64)),                   # group map dtype
    dict(s=torch.ones(8, dtype=torch.bfloat16)),                 # scale dtype
    dict(b=torch.zeros(4)),                                      # bias shape
    dict(x=torch.zeros(2, 4, 4, 6), s=torch.ones(6), b=torch.zeros(6),
         g=torch.zeros(6, dtype=torch.int32), offset=True),      # offset with C4 % 4
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(x=torch.zeros(2, 4, 4, 8), s=torch.ones(8), b=torch.zeros(8),
                g=torch.zeros(8, dtype=torch.int32), groups=2, count=4, offset=False)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        _check_nhwc(args["x"], args["s"], args["b"], args["g"], args["groups"], args["count"],
                    args["offset"])


def test_non_cuda_device_raises():
    x = torch.zeros(2, 4, 4, 8, device="meta")
    with pytest.raises(ValueError):
        gn_silu_nhwc(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"),
                     torch.zeros(8, dtype=torch.int32, device="meta"), 2, 4)
