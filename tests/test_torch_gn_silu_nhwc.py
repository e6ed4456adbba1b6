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


# -- the one-launch kernel's grid plan and order of summation ---------------------

# The 33 GroupNorm sites of the packed flagship's forward (H, W, C4, groups,
# offset), as chip_smoke.packed_sites lists them for artifacts/flagship_synth.
FLAGSHIP_SITES = [
    (128, 64, 128, 32, False), (129, 65, 128, 32, True), (64, 32, 128, 32, False),
    (65, 33, 256, 32, True), (32, 16, 256, 32, False), (33, 17, 384, 32, True),
    (16, 8, 384, 32, False), (17, 9, 512, 32, True), (8, 4, 512, 32, False),
    (9, 5, 640, 32, True), (8, 4, 160, 32, False), (8, 4, 160, 32, False),
    (8, 4, 320, 32, False), (8, 4, 160, 32, False), (8, 4, 1280, 32, False),
    (9, 5, 512, 32, True), (8, 4, 1024, 32, False), (9, 5, 512, 32, True),
    (16, 8, 1024, 32, False), (17, 9, 384, 32, True), (16, 8, 768, 32, False),
    (17, 9, 384, 32, True), (32, 16, 768, 32, False), (33, 17, 256, 32, True),
    (32, 16, 512, 32, False), (33, 17, 256, 32, True), (64, 32, 512, 32, False),
    (65, 33, 128, 32, True), (64, 32, 256, 32, False), (65, 33, 128, 32, True),
    (128, 64, 256, 32, False), (129, 65, 128, 32, True), (128, 64, 128, 32, False),
]
# chip_smoke.py phase 9's odd shapes (H, W, C4, groups)
ODD_SHAPES = [(9, 5, 32, 4), (17, 9, 64, 8), (13, 7, 32, 4), (11, 7, 36, 3), (5, 7, 30, 5),
              (16, 8, 64, 4)]
SMS = 132  # an H100's SMs


def test_plan_constants_match_the_kernel_source():
    """The plan's copies of the kernel's block size and shared-memory ceiling."""
    import re

    from sddm_tpu_torch.ops import gn_silu as ops

    src = ops.SOURCE.read_text()
    for name, value in (("kThreadsN", ops._THREADS_N), ("kSmemMaxN", ops._SMEM_MAX)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 16, 200])
def test_plan_covers_every_position_once_and_fits_the_card(b, elem):
    from sddm_tpu_torch.ops.gn_silu import _SMEM_MAX, nhwc_fixed_bytes, nhwc_plan

    shapes = [(h, w, c4, g) for h, w, c4, g, _ in FLAGSHIP_SITES] + ODD_SHAPES
    for h, w, c4, groups in shapes:
        hw, pack = h * w, 16 // elem
        vec = c4 % pack == 0
        p = nhwc_plan(b, h, w, c4, groups, elem, vec, SMS)
        where = f"[{b}, {h}, {w}, {c4}] elem {elem}: {p}"
        # K ranges of `rows` positions cover a row once, none of them empty
        covered = np.zeros(hw, np.int64)
        for k in range(p.k):
            start, stop = k * p.rows, min(hw, (k + 1) * p.rows)
            assert start < stop, where
            covered[start:stop] += 1
            if vec:  # 16-byte packs start on 16 bytes in every batch row
                assert all((row * hw + start) * c4 * elem % 16 == 0 for row in range(b)), where
        assert (covered == 1).all(), where
        # every item is one block's, and every block has one: block j takes
        # items j, j + grid, ...
        items = b * p.k
        owners = np.arange(items) % p.grid
        assert 1 <= p.grid <= min(items, SMS), where
        assert np.bincount(owners, minlength=p.grid).max() == p.per_block, where
        assert np.bincount(owners, minlength=p.grid).min() >= 1, where
        # the staged positions fit the block's shared memory, as many as fit
        fixed = nhwc_fixed_bytes(c4, groups, pack if vec else 1)
        assert 0 <= p.staged <= p.rows, where
        assert p.smem == fixed + p.per_block * p.staged * c4 * elem <= _SMEM_MAX, where
        if p.staged < p.rows:
            assert fixed + p.per_block * (p.staged + 1) * c4 * elem > _SMEM_MAX, where
        # the workspace is what the kernel writes: [B * K, 2, C4] partial sums
        assert p.work == items * 2 * c4, where


def test_plan_of_the_largest_site_rereads_only_what_does_not_fit():
    from sddm_tpu_torch.ops.gn_silu import nhwc_plan

    p = nhwc_plan(16, 128, 64, 256, 32, 2, True, SMS)
    assert (p.k, p.rows, p.grid, p.per_block) == (8, 1024, 128, 1)
    assert 0 < p.staged < p.rows  # the six largest sites outgrow shared memory
    small = nhwc_plan(16, 8, 4, 160, 32, 2, True, SMS)
    assert (small.k, small.staged) == (1, small.rows)  # one block a row: no grid barrier


@pytest.mark.parametrize("groups,sections", [
    (32, (32,)), (32, (64,)), (32, (96, 64)), (4, (8, 4)), (4, (4, 12)), (2, (8,)), (5, (30,)),
])
def test_group_order_lists_each_groups_members(groups, sections):
    from sddm_tpu_torch.ops.gn_silu import group_order

    _, group_of, _ = port_plan(groups, sections)
    order = group_order(torch.as_tensor(group_of, dtype=torch.int32), groups)
    assert order.dtype == torch.int32 and order.shape == (groups + 1 + len(group_of),)
    offsets, members = order[:groups + 1].numpy(), order[groups + 1:].numpy()
    assert offsets[0] == 0 and offsets[-1] == len(group_of)
    np.testing.assert_array_equal(np.sort(members), np.arange(len(group_of)))
    for g in range(groups):
        listed = members[offsets[g]:offsets[g + 1]]
        np.testing.assert_array_equal(listed, np.flatnonzero(group_of == g))


def test_group_order_leaves_out_of_range_channels_last():
    from sddm_tpu_torch.ops.gn_silu import group_order

    order = group_order(torch.tensor([1, 3, 0, -1, 1, 2], dtype=torch.int32), 3)
    np.testing.assert_array_equal(order.numpy(), [0, 1, 3, 4, 2, 0, 4, 5, 1, 3])


def _kernel_order(x, scale, bias, group_of, groups, count, offset, sms, eps=1e-5):
    """The kernel's order of summation, transcribed: f32 sums of each (row,
    range) item, then per row its K partials in rank order, then per group
    over the group-major member list; the same arithmetic after it."""
    from sddm_tpu_torch.ops.gn_silu import _divisor, group_order, nhwc_plan

    b, h, w, c4 = x.shape
    p = nhwc_plan(b, h, w, c4, groups, x.element_size(), True, sms)
    order = group_order(torch.as_tensor(group_of, dtype=torch.int32), groups)
    offsets, members = order[:groups + 1].tolist(), order[groups + 1:].long()
    x32 = x.float().reshape(b, h * w, c4)
    n = _divisor(h, w, count, offset)
    mu, iv = torch.empty(b, c4), torch.empty(b, c4)
    for row in range(b):
        cs = torch.zeros(2, c4)
        for k in range(p.k):
            seg = x32[row, k * p.rows:(k + 1) * p.rows]
            cs = cs + torch.stack([seg.sum(0), (seg * seg).sum(0)])
        for g in range(groups):
            s = cs[:, members[offsets[g]:offsets[g + 1]]].sum(1)
            mean = s[0] / n
            var = torch.clamp_min(s[1] / n - mean * mean, 0.0)
            chans = torch.as_tensor(group_of) == g
            mu[row, chans], iv[row, chans] = mean, torch.rsqrt(var + eps)
    y = (x32 - mu[:, None]) * iv[:, None] * scale + bias
    y = (y * torch.sigmoid(y)).reshape(x.shape)
    if offset:
        y = y * torch.from_numpy(_offset_mask_np(h, w, c4 // 4))
    return y


@pytest.mark.parametrize("b,h,w,sections,groups,offset,sms", [
    (2, 32, 16, (16,), 4, False, SMS),   # K = 8 ranges a row
    (2, 33, 17, (16,), 4, True, SMS),    # offset site, ranges start mid-row
    (5, 9, 5, (8,), 4, True, 4),         # more items than blocks: blocks loop
    (1, 16, 8, (8, 4), 4, False, SMS),   # B = 1, a concatenated plan
])
def test_kernel_order_of_summation_matches_the_plain_version(b, h, w, sections, groups, offset,
                                                             sms):
    rng = np.random.default_rng(h * w)
    c4 = 4 * sum(sections)
    _, group_of, count = port_plan(groups, sections)
    x = rng.standard_normal((b, h, w, c4)).astype(np.float32) * 1.5 + 0.3
    if offset:
        x = x * _offset_mask_np(h, w, c4 // 4)
    sc = rng.standard_normal(c4).astype(np.float32)
    bi = rng.standard_normal(c4).astype(np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(bi))
    got = _kernel_order(*args, group_of, groups, count, offset, sms)
    want = gn_silu_nhwc_reference(*args, torch.as_tensor(group_of, dtype=torch.int32), groups,
                                  count, offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_cpu_tensor_with_group_order_takes_reference_without_launch():
    from sddm_tpu_torch.ops.gn_silu import group_order

    x = torch.randn(2, 5, 3, 16, generator=torch.Generator().manual_seed(1))
    group_of = torch.arange(16, dtype=torch.int32) // 4
    args = (torch.ones(16), torch.zeros(16), group_of, 4, 4)
    before = gn_silu_nhwc.launches
    got = gn_silu_nhwc(x, *args, offset=True, order=group_order(group_of, 4))
    assert torch.equal(got, gn_silu_nhwc_reference(x, *args, offset=True))
    assert gn_silu_nhwc.launches == before


def test_gn_site_keeps_its_group_order_as_an_unsaved_buffer():
    from sddm_tpu_torch.models.unet_packed import _GN as PortGN
    from sddm_tpu_torch.ops.gn_silu import group_order

    _, group_of, count = port_plan(4, (8, 4))
    gn = PortGN(np.ones(48), np.zeros(48), group_of, 4, count)
    assert torch.equal(gn.order, group_order(torch.as_tensor(group_of, dtype=torch.int32), 4))
    assert "order" not in gn.state_dict()
