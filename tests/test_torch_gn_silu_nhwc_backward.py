"""The NHWC GroupNorm + SiLU (+ offset mask) backward of the PyTorch port
(``sddm_tpu_torch.ops.gn_silu``): its plain version, the closed form
``gn_silu_nhwc_backward_reference``, against torch autograd of
``gn_silu_nhwc_reference`` and against ``jax.vjp`` of the JAX packed
engine's ``_GN`` -> ``jax.nn.silu`` (-> offset mask), what XLA
differentiates when the JAX package trains its packed twin, on the same
seeded numpy inputs; ``gradcheck`` of ``GroupNormSiLUNhwcFunction``; and the
CUDA kernel's plan (``nhwc_backward_plan``) and order of summation, which run
here without a card: the plan's constants against
``csrc/gn_silu_nhwc_bwd.cu``, its cover of every position and channel at the
flagship's 33 packed sites and odd shapes (each element staged once at the
flagship's sites, the schedule of tickets getting through), and a float32
transcription of the kernel's sums held against the plain version.

Tolerances, as max |d| against the largest |reference| of each output
(``scale``): float32 2e-6 of the scale (the sums are taken in other orders;
the closed form's group means cancel to a few f32 ulps of the scale);
bfloat16 dx one bf16 ulp (2**-7 relative) plus 2e-6 of the scale, where
either side may round the same f32 value the other way.  Against JAX in
bfloat16, dx takes one bf16 ulp of the scale: JAX's bf16 dx is its float32
cotangent rounded once, which may sit one ulp of the scale's binade from the
port's float32 value rounded once.  The transcription of the kernels' order
and the float64 plain version: 2e-6 of the scale.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.models.unet_packed import _GN, _offset_mask_np
from sddm_tpu.models.unet_packed import _packed_gn_plan as jax_gn_plan
from sddm_tpu_torch import compare_gn_silu_backward
from sddm_tpu_torch.models.unet_packed import _packed_gn_plan
from sddm_tpu_torch.ops import gn_silu as ops
from sddm_tpu_torch.ops.gn_silu import (
    GroupNormSiLUNhwcFunction,
    _divisor,
    _nhwc_moments,
    gn_silu_nhwc,
    gn_silu_nhwc_backward,
    gn_silu_nhwc_backward_reference,
    gn_silu_nhwc_reference,
    group_order,
    nhwc_backward_plan,
)

BF16_ULP = 2.0**-7
REL = 2e-6
SMS, PER_SM = 132, 1  # an H100's SMs; the kernel's blocks an SM

# (B, H, W, sections, groups, offset, packed): a decoder concat whose group
# map interleaves two sections, an identity (unpacked) site, an offset site
SITES = [
    (2, 6, 4, (8, 4), 4, False, True),
    (3, 4, 2, (20,), 4, False, False),
    (2, 7, 5, (8,), 4, True, True),
]
SITE_IDS = ["two-sections", "identity", "offset"]


def _site(b, h, w, sections, groups, offset, packed, seed, dtype=np.float32):
    """Seeded x (zero outside the offset grid, as the engine masks it), dy,
    scale, bias and the site's channel -> group map and count."""
    rng = np.random.default_rng(seed)
    c = sum(sections)
    c4 = 4 * c if packed else c
    x = (rng.standard_normal((b, h, w, c4)) * 1.5 + 0.3 + 0.5 * rng.standard_normal(c4))
    if offset:
        x = x * _offset_mask_np(h, w, c)
    dy = rng.standard_normal((b, h, w, c4))
    sc = rng.uniform(0.5, 1.5, c4)
    bi = 0.3 * rng.standard_normal(c4)
    if packed:
        _, group_of, count = _packed_gn_plan(groups, sections)
    else:
        count = c // groups
        group_of = np.arange(c) // count
    return ([a.astype(dtype) for a in (x, dy)] + [a.astype(np.float32) for a in (sc, bi)]
            + [np.asarray(group_of, np.int32), count])


def _args(x, dy, sc, bi, group_of, dtype=torch.float32):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype), torch.from_numpy(sc),
            torch.from_numpy(bi), torch.from_numpy(group_of))


def _hold(got, want, dtype, bf16_scale_ulp=False, rel=REL):
    for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
        g, w = g.double(), w.double()
        scale = float(w.abs().max())
        bf16_dx = name == "dx" and dtype == torch.bfloat16
        rtol = BF16_ULP if bf16_dx else 0.0
        atol = (BF16_ULP if bf16_dx and bf16_scale_ulp else rel) * scale
        err = (g - w).abs()
        assert bool(torch.all(err <= atol + rtol * w.abs())), \
            f"{name}: max|d| {float(err.max()):.3e} at scale {scale:.3e}"


def _autograd(x, dy, sc, bi, group_of, groups, count, offset):
    x = x.clone().requires_grad_()
    sc, bi = sc.clone().requires_grad_(), bi.clone().requires_grad_()
    gn_silu_nhwc_reference(x, sc, bi, group_of, groups, count, offset).backward(dy)
    return x.grad, sc.grad, bi.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("site", SITES, ids=SITE_IDS)
def test_plain_backward_matches_torch_autograd(site, dtype):
    b, h, w, sections, groups, offset, packed = site
    x, dy, sc, bi, group_of, count = _site(*site, seed=h * w)
    args = _args(x, dy, sc, bi, group_of, dtype)
    got = gn_silu_nhwc_backward_reference(*args, groups, count, offset)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _hold(got, _autograd(*args, groups, count, offset), dtype)


def _jax_vjp(x, dy, sc, bi, sections, groups, offset, packed, dtype):
    """``_GN`` -> ``jax.nn.silu`` (-> mask) -> ``astype(x.dtype)``, as
    ``sddm_tpu/models/unet_packed.py``'s ``run_rb`` computes a site,
    differentiated by ``jax.vjp`` with respect to x, scale and bias."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    h, w, c4 = x.shape[1:]
    plan = jax_gn_plan(groups, sections) if packed else None

    def f(xj, scale, bias):
        y = jax.nn.silu(_GN(scale, bias, groups, plan, offset=offset)(xj))
        if offset:
            y = y * jnp.asarray(_offset_mask_np(h, w, c4 // 4), xj.dtype)
        return y.astype(xj.dtype)

    _, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), jnp.asarray(sc), jnp.asarray(bi))
    grads = vjp(jnp.asarray(dy).astype(jdt))
    return tuple(torch.from_numpy(np.array(g.astype(jnp.float32))) for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("site", SITES, ids=SITE_IDS)
def test_plain_backward_matches_jax_vjp_of_gn(site, dtype):
    b, h, w, sections, groups, offset, packed = site
    x, dy, sc, bi, group_of, count = _site(*site, seed=7 * h * w)
    args = _args(x, dy, sc, bi, group_of, dtype)
    got = gn_silu_nhwc_backward_reference(*args, groups, count, offset)
    xq, dyq = (a.float().numpy() for a in args[:2])  # the values both sides see
    want = _jax_vjp(xq, dyq, sc, bi, sections, groups, offset, packed, dtype)
    _hold(got, want, dtype, bf16_scale_ulp=True)


@pytest.mark.parametrize("site,constant", [(s, False) for s in SITES]
                         + [((2, 4, 4, (8,), 4, False, True), True)],
                         ids=SITE_IDS + ["constant-group"])
def test_function_gradcheck_float64(site, constant):
    """The autograd Function on the CPU (both directions on their plain
    versions, in float64 for a float64 input) against numerical differences;
    the constant case holds a group of one value, 1000.1, whose s2 / n -
    mean^2 rounds below 0, where the clamp passes no gradient."""
    b, h, w, sections, groups, offset, packed = site
    x, dy, sc, bi, group_of, count = _site(*site, seed=11, dtype=np.float64)
    g = torch.from_numpy(group_of)
    if constant:
        x[:, :, :, group_of == 1] = 1000.1
        _, _, v = _nhwc_moments(torch.from_numpy(x), g, groups, _divisor(h, w, count, offset))
        assert bool((v[:, 1] < 0).all()), "the case must exercise the clamp"
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(sc.astype(np.float64)).requires_grad_()
    bt = torch.from_numpy(bi.astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: GroupNormSiLUNhwcFunction.apply(*a, g, groups, count, offset, 1e-5),
        (xt, st, bt))


def test_near_constant_group_drops_the_clamped_term(dtype=torch.float32):
    """Near-constant groups at 1000, some of whose s2 / n - mean^2 round
    below 0 in float32: the closed form equals torch autograd of the forward,
    which passes no gradient through ``clamp_min`` there, and stays finite.
    Here r = rsqrt(eps) = 316 magnifies the rounding of x - mean, so dx is
    held at 2e-4 of its scale (read 7.3e-5); keeping the clamped term would
    read 3e-3."""
    x, dy, sc, bi, group_of, count = _site(2, 8, 6, (8,), 4, False, True, seed=3)
    x = (1000.0 + 1e-3 * np.random.default_rng(0).standard_normal(x.shape)).astype(np.float32)
    args = _args(x, dy, sc, bi, group_of, dtype)
    _, _, v = _nhwc_moments(args[0], args[4], 4, _divisor(8, 6, count, False))
    assert bool((v < 0).any()) and bool((v >= 0).any()), "the case must exercise the clamp"
    got = gn_silu_nhwc_backward_reference(*args, 4, count, False)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _hold(got, _autograd(*args, 4, count, False), dtype, rel=2e-4)


def test_reference_writes_the_statistics_the_backward_reads():
    x, _, sc, bi, group_of, count = _site(*SITES[2], seed=5)
    xt, g = torch.from_numpy(x), torch.from_numpy(group_of)
    stats = torch.full((2, 4, 2), float("nan"))
    y = gn_silu_nhwc_reference(xt, torch.from_numpy(sc), torch.from_numpy(bi), g, 4, count, True,
                               stats=stats)
    _, mean, v = _nhwc_moments(xt, g, 4, _divisor(7, 5, count, True))
    assert torch.equal(stats, torch.stack([mean, v], -1))
    assert torch.equal(y, gn_silu_nhwc_reference(xt, torch.from_numpy(sc), torch.from_numpy(bi),
                                                 g, 4, count, True))


def test_cpu_wrappers_are_the_plain_versions():
    x, dy, sc, bi, group_of, count = _site(*SITES[0], seed=9)
    args = _args(x, dy, sc, bi, group_of)
    before = (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches)
    got = gn_silu_nhwc_backward(*args, 4, count, False, order=group_order(args[4], 4))
    for g, w in zip(got, gn_silu_nhwc_backward_reference(*args, 4, count, False)):
        assert torch.equal(g, w)
    assert (gn_silu_nhwc.launches, gn_silu_nhwc_backward.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        gn_silu_nhwc_backward(*(a.to("meta") for a in args), 4, count)


def test_function_routes_both_directions_and_saves_the_statistics():
    """The Function calls the forward and backward it is given (a caller
    routes them to the plain versions), hands the forward a ``[B, G, 2]``
    statistics buffer and the backward the same buffer."""
    x, dy, sc, bi, group_of, count = _site(*SITES[2], seed=13)
    xt, dyt, st, bt, g = _args(x, dy, sc, bi, group_of)
    seen = {}

    def fwd(*a, order=None, stats=None):
        seen["forward"] = stats
        return gn_silu_nhwc(*a, order=order, stats=stats)

    def bwd(*a, order=None, stats=None):
        seen["backward"] = stats
        return gn_silu_nhwc_backward(*a, order=order, stats=stats)

    xr, sr, br = (t.clone().requires_grad_() for t in (xt, st, bt))
    y = GroupNormSiLUNhwcFunction.apply(xr, sr, br, g, 4, count, True, 1e-5, None, fwd, bwd)
    y.backward(dyt)
    assert seen["forward"] is seen["backward"] and seen["forward"].shape == (2, 4, 2)
    assert torch.equal(y.detach(), gn_silu_nhwc_reference(xt, st, bt, g, 4, count, True))
    want = gn_silu_nhwc_backward_reference(xt, dyt, st, bt, g, 4, count, True)
    for got, ref in zip((xr.grad, sr.grad, br.grad), want):
        assert torch.equal(got, ref)


# -- the kernels' plan and order of summation -----------------------------------------

# The 33 GroupNorm sites of the packed flagship's forward (H, W, C4, groups,
# offset), as chip_smoke.packed_sites lists them for artifacts/flagship_synth:
# the sites of a packed train step at batch 16.
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
# odd shapes (H, W, C4, groups): C4 not a multiple of 8 or 4, odd H * W
ODD_SHAPES = [(9, 5, 32, 4), (11, 7, 36, 3), (5, 7, 30, 5), (3, 3, 4096, 2)]


def test_plan_constants_match_the_kernel_source():
    """The plan's copies of the kernel's block size, shared-memory ceiling and
    fixed shared memory; one block of that ceiling fits an H100 SM (228 KB,
    1 KB kept a block)."""
    src = ops.NHWC_BACKWARD_SOURCE.read_text()
    for name, value in (("kThreadsB", ops._THREADS_BN), ("kSmemMaxB", ops._SMEM_MAX_BN),
                        ("kBlocksPerSmB", PER_SM)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
    assert ops._SMEM_MAX_BN + 1024 <= 233472
    assert int(re.search(r"constexpr int kPackBytesB = (\d+);", src).group(1)) == \
        ops._PACK_BYTES_BN
    assert ("return ((128 + 4 * (2 * P * kThreadsB + 3 * C4 + 6 * G + G + 1 + C4) + 127) / 128) "
            "* 128;" in src)
    assert "return ((2 * (int64_t)staged * C4 * elem + 8 * (int64_t)G + 15) / 16) * 16;" in src
    for c4, g, pack in ((128, 32, 8), (1280, 32, 4), (30, 5, 1), (4096, 1024, 8)):
        words = 2 * pack * 512 + 3 * c4 + 6 * g + g + 1 + c4
        assert ops.nhwc_backward_fixed_bytes(c4, g, pack) == ((128 + 4 * words + 127) // 128) * 128
    for staged, c4, g, elem in ((63, 256, 32, 2), (1, 30, 5, 2), (7, 36, 3, 4)):
        assert ops.nhwc_backward_item_bytes(staged, c4, g, elem) == \
            -(-(2 * staged * c4 * elem + 8 * g) // 16) * 16
    assert ops.nhwc_backward_fixed_bytes(4096, 1024, 8) <= ops._SMEM_MAX_BN
    # one cooperative launch, whose kernel name the profiler checks match
    assert "cudaLaunchCooperativeKernel" in src and "nhwc_bwd_fused" in src
    # the forward's statistics reach the backward only through the optional buffer
    assert "float* stats;" in ops.SOURCE.read_text()


def _schedule_finishes(p) -> bool:
    """Run the kernel's schedule: block j takes items j, j + grid, ...; A
    (an item's sums) takes its row's ticket (the kernel takes it at the start
    of the next B, before any wait, or at the end of A(0)), B (its dx) waits
    until the row's k items have taken theirs; a block runs A(0), A(1)...
    and B(0), B(1)... in the kernel's order (two buffers: A(t), then B(t -
    1); one: A(t), B(t)).  True when every block gets through."""
    steps = []
    for j in range(p.grid):
        mine = list(range(j, p.items, p.grid))
        if p.buffers == 2:
            seq = [("A", mine[0])]
            for t in range(1, len(mine)):
                seq += [("A", mine[t]), ("B", mine[t - 1])]
            seq.append(("B", mine[-1]))
        else:
            seq = [step for item in mine for step in (("A", item), ("B", item))]
        steps.append(seq)
    cursor = [0] * p.grid
    taken = np.zeros(p.items // p.k, np.int64)
    progressed = True
    while progressed:
        progressed = False
        for j, seq in enumerate(steps):
            while cursor[j] < len(seq):
                kind, item = seq[cursor[j]]
                if kind == "A":
                    taken[item // p.k] += 1
                elif taken[item // p.k] < p.k:
                    break
                cursor[j] += 1
                progressed = True
    return all(c == len(seq) for c, seq in zip(cursor, steps))


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 16, 200])
def test_plan_covers_every_position_and_channel_once(b, elem):
    """Every position of a row in one range, every item in one block, no
    block with two items of a row, the grid no larger than the resident
    blocks, what a block stages within its shared memory, and the schedule
    of tickets gets through (no block waits for a row that cannot
    finish)."""
    shapes = [(h, w, c4, g) for h, w, c4, g, _ in FLAGSHIP_SITES] + ODD_SHAPES
    blocks = SMS * PER_SM
    for h, w, c4, groups in shapes:
        hw = h * w
        vec = c4 % (16 // elem) == 0
        p = nhwc_backward_plan(b, h, w, c4, groups, elem, vec, SMS, PER_SM)
        where = f"[{b}, {h}, {w}, {c4}] elem {elem}: {p}"
        covered = np.zeros(hw, np.int64)
        for k in range(p.k):
            start, stop = k * p.rows, min(hw, (k + 1) * p.rows)
            assert start < stop, where
            covered[start:stop] += 1
        assert (covered == 1).all(), where
        assert p.items == b * p.k and 1 <= p.grid <= min(p.items, blocks), where
        assert p.waves == -(-p.items // p.grid), where
        # a block holds at most one item of a row (two with two buffers)
        assert p.k <= p.grid * p.buffers, where
        owner = np.arange(p.items) % p.grid  # block of each item
        wave = np.arange(p.items) // p.grid
        if p.buffers == 1:  # a wave is whole rows: no row waits for the next wave
            assert all(len(set(owner[r * p.k:(r + 1) * p.k])) == p.k for r in range(b)), where
            assert p.grid % p.k == 0, where
            assert all(len(set(wave[r * p.k:(r + 1) * p.k])) == 1 for r in range(b)), where
        else:  # every resident block
            assert p.grid == min(p.items, blocks), where
        fixed = ops.nhwc_backward_fixed_bytes(c4, groups, ops._PACK_BYTES_BN // elem if vec else 1)
        assert 0 <= p.staged <= p.rows and p.buffers in (1, 2), where
        # two items a block only with bulk copies, every position staged, and
        # more than one wave
        assert p.buffers == 1 or (vec and p.staged == p.rows and p.waves > 1), where
        each = ops.nhwc_backward_item_bytes(p.staged, c4, groups, elem)
        assert p.smem == fixed + p.buffers * each <= ops._SMEM_MAX_BN, where
        more = ops.nhwc_backward_item_bytes(p.staged + 1, c4, groups, elem)
        assert (fixed + p.buffers * more > ops._SMEM_MAX_BN) or p.staged == p.rows, where
        assert p.work == b * 2 * (c4 + groups) + (p.items * 2 * (c4 + groups) if p.k > 1
                                                   else 0), where
        if b <= 16:
            assert _schedule_finishes(p), where


@pytest.mark.parametrize("elem", [2, 4])
def test_plan_stages_each_flagship_element_once(elem):
    """At the 33 packed sites of a batch-16 step every position of x and dy
    is kept in shared memory by the one block that reads it (no reread), and
    a wave's staged bytes fit the grid's shared memory."""
    for h, w, c4, groups, _ in FLAGSHIP_SITES:
        p = nhwc_backward_plan(16, h, w, c4, groups, elem, True, SMS, PER_SM)
        assert p.staged == p.rows, p
        staged = sum(min(p.rows, h * w - k * p.rows) for k in range(p.k)) * 16
        assert staged == 16 * h * w, p
        pack = ops._PACK_BYTES_BN // elem
        room = ops._SMEM_MAX_BN - ops.nhwc_backward_fixed_bytes(c4, groups, pack)
        assert p.buffers * ops.nhwc_backward_item_bytes(p.rows, c4, groups, elem) <= room, p


def test_plan_of_the_largest_site():
    # bf16: two items of 102 positions a block, 81 a row, 10 waves
    p = nhwc_backward_plan(16, 128, 64, 256, 32, 2, True, SMS, PER_SM)
    assert (p.k, p.rows, p.staged, p.buffers, p.items, p.grid, p.waves) == \
        (81, 102, 102, 2, 1296, 132, 10)
    # f32: two items of 53 positions, a row's 155 ranges over two waves
    p = nhwc_backward_plan(16, 128, 64, 256, 32, 4, True, SMS, PER_SM)
    assert (p.k, p.rows, p.staged, p.buffers, p.items, p.grid, p.waves) == \
        (155, 53, 53, 2, 2480, 132, 19)
    # without 16-byte spans, one item a block and a wave of one whole row
    p = nhwc_backward_plan(16, 128, 64, 256, 32, 4, False, SMS, PER_SM)
    assert (p.k, p.buffers, p.grid % p.k) == (131, 1, 0)
    # the offset site
    p = nhwc_backward_plan(16, 129, 65, 128, 32, 2, True, SMS, PER_SM)
    assert (p.k, p.grid, p.waves, p.buffers) == (41, 132, 5, 2)
    # B = 1 spreads a row over the card; a small row is one block's
    assert nhwc_backward_plan(1, 128, 64, 256, 32, 2, True, SMS, PER_SM).k == 131
    assert nhwc_backward_plan(16, 8, 4, 160, 32, 2, True, SMS, PER_SM).k == 1  # 10 KB a row
    # without 16-byte packs one item a block
    assert nhwc_backward_plan(16, 128, 64, 256, 32, 2, False, SMS, PER_SM).buffers == 1
    # a row longer than the card holds: k up to the grid, the rest of a range read again
    p = nhwc_backward_plan(1, 512, 128, 256, 32, 2, True, SMS, PER_SM)
    assert (p.k, p.grid, p.rows, p.staged, p.buffers) == (132, 132, 497, 205, 1)
    # the widest channels the kernel takes: one position a range
    p = nhwc_backward_plan(2, 4, 4, 4096, 1024, 4, True, SMS, PER_SM)
    assert (p.k, p.rows, p.staged) == (16, 1, 1)


def _sequential(rows: np.ndarray) -> np.ndarray:
    """Sum over axis 0 one row at a time, in float32."""
    acc = np.zeros(rows.shape[1:], np.float32)
    for r in rows:
        acc = acc + r
    return acc


def _butterfly(lanes: np.ndarray) -> np.ndarray:
    """``warp_sum`` and ``fold_ranks``' tree: L lanes (axis 0, a power of two)
    folded by xor shuffles L / 2, ..., 2, 1; lane 0's value."""
    v = lanes.astype(np.float32)
    n = len(v)
    off = n // 2
    while off:
        v = v + v[np.arange(n) ^ off]
        off //= 2
    return v[0]


def _lanes_over(vals: np.ndarray, n_lanes: int) -> np.ndarray:
    """The sum over axis 0 by ``n_lanes`` lanes: lane q sums entries q, q +
    n_lanes, ... in order, then the shuffle tree."""
    lanes = np.stack([_sequential(vals[q::n_lanes]) if q < len(vals)
                      else np.zeros(vals.shape[1:], np.float32) for q in range(n_lanes)])
    return _butterfly(lanes)


def _fold_lanes(nv: int) -> int:
    """``fold_ranks``' lanes a value when the block sums ``nv`` values."""
    lanes = 1
    while lanes < 32 and nv * 2 * lanes <= ops._THREADS_BN:
        lanes *= 2
    return lanes


def _fold_ranks(vals: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """``fold_ranks`` of values ``[lo, hi)`` (last axis) of ``vals`` ``[K,
    ..., V]`` over its ranks (axis 0), by one block."""
    return _lanes_over(vals[..., lo:hi], _fold_lanes(hi - lo))


def _four_sums(rows: np.ndarray) -> np.ndarray:
    """Sum over axis 0 by four running sums over rows 0, 1, 2, 3 (mod 4),
    then ((0 + 1) + (2 + 3)), in float32."""
    acc = np.zeros((4,) + rows.shape[1:], np.float32)
    i = 0
    while i + 3 < len(rows):
        acc = acc + rows[i:i + 4]
        i += 4
    while i < len(rows):
        acc[0] = acc[0] + rows[i]
        i += 1
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _fold_groups(vals: np.ndarray) -> np.ndarray:
    """``fold_groups`` of ``vals`` ``[K, G2]`` over its ranks: G2 / 4
    threads a rank, Q = 512 / (G2 / 4) lanes, lane q summing ranks q, q + Q,
    ... in order, then the lanes by four running sums."""
    nq = ops._THREADS_BN // (vals.shape[1] // 4)
    return _four_sums(np.stack([_sequential(vals[q::nq]) for q in range(nq)]))


def _kernel_order(x, dy, sc, bi, group_of, groups, count, offset, sms, per_sm=PER_SM,
                  eps=1e-5):
    """The kernel's order of summation, transcribed in float32: per item,
    each thread's row lane summed in order and the row lanes folded by four
    running sums then ((0 + 1) + (2 + 3)); the item's group partials, each
    group's members times scale by ``ml`` lanes (the largest group's members
    to a power of two, up to 32) and a shuffle tree; each row's
    group sums over the row's ranks by ``fold_groups`` (or, without 16-byte
    spans or with an odd G, ``fold_ranks``' lanes and shuffle tree; an
    item's own where the row is one range); after the items, each block's
    share of the rows' channel sums over their ranks, and of dscale and
    dbias over the rows, by ``fold_ranks``.  The statistics are the plain version's (the
    forward's are held in tests/test_torch_gn_silu_nhwc.py)."""
    b, h, w, c4 = x.shape
    n = np.float32(_divisor(h, w, count, offset))
    P = ops._PACK_BYTES_BN // 4 if c4 % 4 == 0 else 1  # float32: 16-byte spans at C4 % 4 == 0
    p = nhwc_backward_plan(b, h, w, c4, groups, 4, P > 1, sms, per_sm)
    V = c4 // P
    CT = -(-V // ops._THREADS_BN)
    VT = -(-V // CT)
    RL = ops._THREADS_BN // VT
    stats = torch.empty(b, groups, 2)
    gn_silu_nhwc_reference(torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(bi),
                           torch.from_numpy(group_of), groups, count, offset, stats=stats)
    mean, v = stats[..., 0].numpy(), stats[..., 1].numpy()
    r = (1.0 / np.sqrt(np.maximum(v, 0).astype(np.float64) + eps)).astype(np.float32)
    xs = x.reshape(b, h * w, c4)
    g_y = dy.reshape(b, h * w, c4).copy()
    if offset:
        g_y = g_y * _offset_mask_np(h, w, c4 // 4).reshape(1, h * w, c4)
    mu_c, r_c = mean[:, group_of][:, None, :], r[:, group_of][:, None, :]
    xhat = (xs - mu_c) * r_c
    y = xhat * sc + bi
    s = (1.0 / (1.0 + np.exp(-y.astype(np.float64)))).astype(np.float32)
    dz = g_y * (s * (np.float32(1.0) + y * (np.float32(1.0) - s)))
    order = group_order(torch.from_numpy(group_of), groups)
    offsets, members = order[:groups + 1].tolist(), order[groups + 1:].numpy()
    ml = 1  # lanes a group's partial: the largest group's members, to a power of two
    while ml < 32 and ml < max(offsets[g + 1] - offsets[g] for g in range(groups)):
        ml *= 2
    part_c = np.zeros((b, p.k, 2, c4), np.float32)
    part_g = np.zeros((b, p.k, 2, groups), np.float32)
    for row in range(b):
        for k in range(p.k):
            lo, hi = k * p.rows, min(h * w, (k + 1) * p.rows)
            for which, vals in enumerate((dz[row, lo:hi], dz[row, lo:hi] * xhat[row, lo:hi])):
                lane_sums = np.stack([_sequential(vals[l::RL]) if l < len(vals)
                                      else np.zeros(c4, np.float32) for l in range(RL)])
                part_c[row, k, which] = _four_sums(lane_sums)
            scaled = part_c[row, k] * sc  # [2, C4], each product rounded on its own
            for gi in range(groups):
                part_g[row, k, :, gi] = _lanes_over(
                    scaled[:, members[offsets[gi]:offsets[gi + 1]]].T, ml)
    dx = np.empty_like(xs)
    row_c = np.empty((b, 2, c4), np.float32)
    if p.k > 1:  # each row's channel sums, block i taking pairs [i * per, (i + 1) * per)
        pairs = part_c.reshape(b, p.k, 2 * c4).transpose(1, 0, 2).reshape(p.k, b * 2 * c4)
        per = -(-b * 2 * c4 // p.grid)
        row_c[:] = np.concatenate([_fold_ranks(pairs, j0, min(j0 + per, b * 2 * c4))
                                   for j0 in range(0, b * 2 * c4, per)]).reshape(b, 2, c4)
    for row in range(b):
        if p.k > 1:  # every item of the row sums the row's group partials
            flat = part_g[row].reshape(p.k, 2 * groups)
            if P > 1 and groups % 2 == 0:
                gsum = _fold_groups(flat).reshape(2, groups)
            else:
                gsum = _fold_ranks(flat, 0, 2 * groups).reshape(2, groups)
        else:
            gsum, row_c[row] = part_g[row, 0], part_c[row, 0]
        for gi in range(groups):
            a_g = gsum[0, gi] / n
            b_g = np.float32(0.0) if v[row, gi] < 0 else gsum[1, gi] / n
            ch = group_of == gi
            k1, k0, k2 = r[row, gi] * sc[ch], -(r[row, gi] * a_g), -(r[row, gi] * b_g)
            dx[row][:, ch] = k1 * dz[row][:, ch] + (k2 * xhat[row][:, ch] + k0)
    flat = row_c.reshape(b, 2 * c4)
    per = -(-2 * c4 // p.grid)  # block i sums values [i * per, (i + 1) * per) over the rows
    params = np.concatenate([_fold_ranks(flat, j0, min(j0 + per, 2 * c4))
                             for j0 in range(0, 2 * c4, per)]).reshape(2, c4)
    return dx.reshape(x.shape), params[1], params[0]


@pytest.mark.parametrize("b,h,w,sections,groups,offset,packed,sms,per_sm", [
    (2, 32, 16, (16,), 4, False, True, SMS, PER_SM),  # 8 ranges a row
    (2, 33, 17, (16,), 4, True, True, SMS, PER_SM),   # offset site, ranges start mid-row
    (5, 9, 5, (8,), 4, True, True, 4, 1),             # one range a row, 5 rows on 4 blocks
    (1, 16, 8, (8, 4), 4, False, True, SMS, PER_SM),  # B = 1, a concatenated plan
    (3, 4, 2, (20,), 4, False, False, SMS, PER_SM),   # identity site
    (4, 64, 32, (16,), 4, False, True, 4, 1),         # ranges past the shared memory: reread
    (2, 8, 8, (128,), 4, False, True, 4, 1),          # two buffers; row 1 spans two waves
])
def test_kernel_order_of_summation_matches_the_plain_version(b, h, w, sections, groups, offset,
                                                             packed, sms, per_sm):
    x, dy, sc, bi, group_of, count = _site(b, h, w, sections, groups, offset, packed, seed=b * h)
    got = _kernel_order(x, dy, sc, bi, group_of, groups, count, offset, sms, per_sm)
    want = gn_silu_nhwc_backward_reference(*_args(x, dy, sc, bi, group_of, torch.float64),
                                           groups, count, offset)
    _hold([torch.from_numpy(np.asarray(a)) for a in got], want, torch.float32)


def test_kernel_order_with_a_clamped_group():
    """The transcription at a group whose variance rounds below 0 drops the
    term the plain version drops."""
    x, dy, sc, bi, group_of, count = _site(2, 8, 6, (8,), 4, False, True, seed=3)
    x = (1000.0 + 1e-3 * np.random.default_rng(0).standard_normal(x.shape)).astype(np.float32)
    got = _kernel_order(x, dy, sc, bi, group_of, 4, count, False, SMS)
    want = gn_silu_nhwc_backward_reference(*_args(x, dy, sc, bi, group_of), 4, count, False)
    _hold([torch.from_numpy(np.asarray(a)) for a in got], want, torch.float32, rel=1e-5)


def test_compare_keeps_the_earlier_nhwc_plan():
    """``compare_gn_silu_backward --layout nhwc`` launches the two-launch
    design it replaced with that design's own plan: k ranges a row (up to
    two 512-thread blocks an SM, at most 32, none under 16 KB of x), one dx
    block an item and one a 16 channels of dscale and dbias."""
    plan = compare_gn_silu_backward.earlier_nhwc_plan
    k, rows, grid, smem, work = plan(16, 128, 64, 256, 32, 2, SMS)
    assert (k, rows, grid) == (16, 512, 16 * 16 + 16) and work == 16 * 16 * 2 * 256
    assert smem == -(-4 * (2 * 256 + 4 * 32 + 32 + 1 + 256) // 16) * 16
    assert plan(1, 128, 64, 256, 32, 2, SMS)[0] == 32
    assert plan(16, 8, 4, 160, 32, 2, SMS)[0] == 1  # 10 KB a row


def test_compare_nhwc_refuses_without_a_card(tmp_path):
    assert compare_gn_silu_backward.main(["--layout", "nhwc", "--earlier",
                                          str(tmp_path / "none.cu")]) == 2


def _pipeline(mine: int, buffers: int, chunks: int):
    """The kernel's order of copies and waits for a block of ``mine`` items
    (``nhwc_bwd_fused``'s main loop, transcribed): every slot's first item
    copied first, chunk by chunk; A(t) waits for each chunk of item t before
    it reads it; with two buffers A(t), then B(t - 1), which copies chunk c of
    item t + 1 into the slot once it has written dx from chunk c; with one
    A(t), then B(t), which copies item t + 1."""
    events = []

    def copy(t, c):
        if t < mine:
            events.append(("copy", t, c))

    for t in range(buffers):
        for c in range(chunks):
            copy(t, c)

    def finish(t, nxt):
        for c in range(chunks):
            events.append(("dx", t, c))
            copy(nxt, c)

    for t in range(mine + (1 if buffers > 1 else 0)):
        if t < mine:
            for c in range(chunks):
                events.append(("wait", t, c))
        if buffers == 1:
            finish(t, t + 1)
        elif t >= 1:
            finish(t - 1, t + 1)
    return events


@pytest.mark.parametrize("buffers,chunks", [(1, 1), (2, 4)])
@pytest.mark.parametrize("mine", [1, 2, 3, 4, 7, 16])
def test_pipeline_copies_each_chunk_once_before_its_use(mine, buffers, chunks):
    """Each chunk of each item is copied once, into slot t % buffers, before
    A(t) waits for it; that wait (parity (t / buffers) & 1 on the chunk's
    mbarrier) meets the copy of item t, the slot's (t / buffers)-th; no chunk
    of a slot is copied into again before B of its item has read it."""
    events = _pipeline(mine, buffers, chunks)
    want = [(t, c) for t in range(mine) for c in range(chunks)]
    assert sorted((t, c) for kind, t, c in events if kind == "copy") == want
    assert sorted((t, c) for kind, t, c in events if kind == "wait") == want
    assert sorted((t, c) for kind, t, c in events if kind == "dx") == want
    at = {e: i for i, e in enumerate(events)}
    for t, c in want:
        assert at[("copy", t, c)] < at[("wait", t, c)] < at[("dx", t, c)]
        copies_before = [u for kind, u, cc in events[:at[("wait", t, c)]]
                         if kind == "copy" and cc == c and u % buffers == t % buffers]
        assert copies_before[t // buffers] == t  # the phase the wait meets
        if t + buffers < mine:  # the chunk's next copy waits for B(t) to read it
            assert at[("copy", t + buffers, c)] > at[("dx", t, c)]
