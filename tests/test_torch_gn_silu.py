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


# -- the one-launch cluster kernel's plan and order of summation -------------------

# The 33 GroupNorm sites of the plain flagship network's forward (C, H, W, G),
# as chip_smoke.py phase 3 lists them for artifacts/flagship_synth.
FLAGSHIP_SITES = [
    (32, 256, 128, 32), (32, 256, 128, 32), (32, 128, 64, 32), (64, 128, 64, 32),
    (64, 64, 32, 32), (96, 64, 32, 32), (96, 32, 16, 32), (128, 32, 16, 32),
    (128, 16, 8, 32), (160, 16, 8, 32), (160, 8, 4, 32), (160, 8, 4, 32), (320, 8, 4, 32),
    (160, 8, 4, 32), (320, 16, 8, 32), (128, 16, 8, 32), (256, 16, 8, 32), (128, 16, 8, 32),
    (256, 32, 16, 32), (96, 32, 16, 32), (192, 32, 16, 32), (96, 32, 16, 32),
    (192, 64, 32, 32), (64, 64, 32, 32), (128, 64, 32, 32), (64, 64, 32, 32),
    (128, 128, 64, 32), (32, 128, 64, 32), (64, 128, 64, 32), (32, 128, 64, 32),
    (64, 256, 128, 32), (32, 256, 128, 32), (32, 256, 128, 32),
]
# chip_smoke.py phase 3's other shapes (C, H, W, G): the unaligned path, the
# near-constant groups, a run larger than a cluster holds, runs that are not
# a multiple of q units, and the one-element path at q = 8
ODD_SITES = [(12, 7, 5, 4), (16, 8, 8, 16), (4, 1024, 2560, 2), (64, 257, 136, 32),
             (8, 129, 129, 4)]
SMS = 132  # an H100's SMs


def test_nchw_plan_constants_match_the_kernel_source():
    """The plan's copies of the kernel's CTA size, cluster size and shared
    memory ceiling, and the ceiling within what an H100 CTA may take beside
    the static arrays."""
    import re

    from sddm_tpu_torch.ops import gn_silu as ops

    src = ops.SOURCE.read_text()
    for name, value in (("kThreadsC", ops._THREADS_C), ("kClusterC", ops._CLUSTER_C),
                        ("kSmemMaxC", ops._SMEM_MAX_C)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    assert ops._SMEM_MAX_C + 1024 <= 232448


def _nchw_coverage(p, units):
    """How often the kernel's index map, transcribed, visits each unit of a
    run: thread j of rank r takes units lo + j + m * tpr of its slice's first
    `cap` units [lo, mid), kept at offset slot * cap + i - lo of the CTA's
    shared memory, and units mid + j + m * tpr of [mid, hi) from device
    memory.  Returns the visits and the shared-memory offsets used."""
    tpr = p.threads // p.runs
    seen = np.zeros(units, np.int64)
    offsets = set()
    for rank in range(p.q):
        lo, hi = rank * p.slice, min(units, (rank + 1) * p.slice)
        mid = min(hi, lo + p.cap)
        assert lo < hi, f"rank {rank} of {p} has no units"
        for start, stop in ((lo, mid), (mid, hi)):
            for j in range(tpr):
                np.add.at(seen, np.arange(start + j, stop, tpr), 1)
        offsets.update(range(mid - lo))
    return seen, offsets


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 16, 200])
def test_nchw_plan_covers_every_element_once_and_fits_the_card(b, elem):
    from sddm_tpu_torch.ops.gn_silu import nchw_plan

    for c, h, w, g in FLAGSHIP_SITES + ODD_SITES:
        hw, pack = h * w, 16 // elem
        for vec in sorted({hw % pack == 0, False}):
            p = nchw_plan(b, c, hw, g, elem, vec, SMS)
            where = f"[{b}, {c}, {h}, {w}] G={g} elem {elem} vec {vec}: {p}"
            unit = (pack if vec else 1) * elem
            units = c // g * hw // (pack if vec else 1)
            tpr = p.threads // p.runs
            assert p.q in (1, 2, 4, 8), where
            assert 32 <= p.threads <= 512 and p.threads % p.runs == 0 and tpr % 32 == 0, where
            assert p.q == 1 or p.runs == 1, where
            # the grid: a whole number of clusters; cluster (or CTA) k takes
            # runs k * runs ... (k + 1) * runs - 1, every run exactly once
            assert p.grid % p.q == 0 and p.grid == -(-b * g // p.runs) * p.q, where
            owner = np.arange(b * g) // p.runs
            assert np.bincount(owner).min() >= 1 and owner.max() == p.grid // p.q - 1, where
            # every unit of a run is visited once, and the units tile the run
            assert units * (pack if vec else 1) == c // g * hw, where
            seen, offsets = _nchw_coverage(p, units)
            assert (seen == 1).all(), where
            # shared memory: `runs` slots of `cap` units, a slot as large as
            # the slice up to the ceiling; the rest of a slice is reread
            assert p.slice == -(-units // p.q), where
            assert max(offsets) < p.cap and p.reread == p.slice - p.cap >= 0, where
            assert p.cap == min(p.slice, 231424 // (p.runs * unit)), where
            assert p.smem == p.runs * p.cap * unit <= 232448, where
            assert p.packs == -(-p.cap // tpr), where
            # what a cluster holds covers the run, or the plan marks the reread
            assert p.q * p.cap >= units or p.reread > 0, where


def test_nchw_plan_of_the_largest_and_smallest_sites():
    from sddm_tpu_torch.ops.gn_silu import nchw_plan

    big = nchw_plan(16, 64, 256 * 128, 32, 2, True, SMS)
    assert (big.q, big.threads, big.slice, big.cap, big.reread) == (2, 512, 4096, 4096, 0)
    assert big.smem == 65536 and big.grid == 512 * 2  # 64 KB of a 128 KB run a CTA
    mid = nchw_plan(16, 32, 256 * 128, 32, 2, True, SMS)  # 64 KB runs: one CTA each
    assert (mid.q, mid.threads, mid.grid, mid.smem) == (1, 512, 512, 65536)
    small = nchw_plan(16, 160, 8 * 4, 32, 2, True, SMS)
    assert small.q == 1 and small.runs > 1 and small.threads // small.runs == 32  # a warp a run
    assert small.grid >= SMS


def test_nchw_plan_rereads_a_run_larger_than_a_cluster_holds():
    from sddm_tpu_torch.ops.gn_silu import nchw_plan

    for elem in (2, 4):
        p = nchw_plan(2, 4, 1024 * 2560, 2, elem, True, SMS)
        run_bytes = 2 * 1024 * 2560 * elem
        cluster_holds = p.q * p.cap * 16
        assert p.q == 8 and p.reread > 0 and p.smem == 231424
        assert run_bytes >= 4 * cluster_holds


def _nchw_kernel_order(x, weight, bias, groups, sms, eps=1e-5):
    """The kernel's order of summation, transcribed in float32: per thread
    its units kept in shared memory in order, then its reread units, the
    pack's elements in order; a warp xor-shuffle tree; the run's warps in order;
    the cluster's ranks in order; then the same arithmetic after it."""
    from sddm_tpu_torch.ops.gn_silu import nchw_plan

    b, c, h, w = x.shape
    hw, pack = h * w, 16 // x.element_size()
    vec = hw % pack == 0
    p = nchw_plan(b, c, hw, groups, x.element_size(), vec, sms)
    pk = pack if vec else 1
    tpr = p.threads // p.runs
    runs = x.float().numpy().reshape(b * groups, -1)
    n = runs.shape[1]
    units = runs.reshape(b * groups, n // pk, pk)
    f32 = np.float32
    mean, rstd = np.empty(b * groups, f32), np.empty(b * groups, f32)
    lanes, j = np.arange(32), np.arange(tpr)
    for r in range(b * groups):
        total = [f32(0), f32(0)]
        for rank in range(p.q):
            lo, hi = rank * p.slice, min(n // pk, (rank + 1) * p.slice)
            mid = min(hi, lo + p.cap)
            order = []
            for start, stop in ((lo, mid), (mid, hi)):
                i = start + j
                while (i < stop).any():
                    order.append((i, stop))
                    i = i + tpr
            s, ss = np.zeros(tpr, f32), np.zeros(tpr, f32)
            for i, stop in order:
                ok = i < stop
                vals = units[r, np.where(ok, i, 0)]
                for e in range(pk):
                    s = np.where(ok, s + vals[:, e], s)
                    ss = np.where(ok, ss + vals[:, e] * vals[:, e], ss)
            cta = []
            for v in (s, ss):
                v = v.reshape(-1, 32)
                for off in (16, 8, 4, 2, 1):
                    v = v + v[:, lanes ^ off]
                acc = f32(0)
                for wsum in v[:, 0]:
                    acc = f32(acc + wsum)
                cta.append(acc)
            total = [f32(total[0] + cta[0]), f32(total[1] + cta[1])]
        mean[r] = total[0] / f32(n)
        var = max(f32(total[1] / f32(n)) - f32(mean[r] * mean[r]), f32(0))
        rstd[r] = f32(1) / np.sqrt(f32(var + f32(eps)))
    xg = torch.from_numpy(runs.reshape(b, groups, c // groups, hw))
    mu = torch.from_numpy(mean).reshape(b, groups, 1, 1)
    iv = torch.from_numpy(rstd).reshape(b, groups, 1, 1)
    shape = (1, groups, c // groups, 1)
    y = (xg - mu) * (iv * weight.reshape(shape)) + bias.reshape(shape)
    return (y * torch.sigmoid(y)).reshape(x.shape)


@pytest.mark.parametrize("shape,groups,sms", [
    ((1, 4, 64, 128), 2, SMS),    # q = 8: a run split across a cluster
    ((16, 160, 8, 4), 32, SMS),   # one warp a run, two runs a CTA
    ((1, 2, 37, 180), 1, SMS),    # q = 8 slices of 417 units, the last 411
    ((1, 1, 1024, 1280), 1, SMS),  # a slice larger than shared memory: the reread
    ((1, 8, 129, 129), 4, SMS),   # one element a copy, q = 8
    ((2, 12, 16, 16), 3, 4),      # several warps a run on a 4-SM card
])
def test_nchw_kernel_order_of_summation_matches_the_plain_version(shape, groups, sms):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32))
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1]).astype(np.float32))
    bias = torch.from_numpy((0.2 * rng.standard_normal(shape[1])).astype(np.float32))
    got = _nchw_kernel_order(x, weight, bias, groups, sms)
    want = gn_silu_reference(x, weight, bias, groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
