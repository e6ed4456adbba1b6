"""The GroupNorm + SiLU backward of the PyTorch port
(``sddm_tpu_torch.ops.gn_silu``): its plain version, the closed form
``gn_silu_backward_reference``, against torch autograd of
``gn_silu_reference`` and against ``jax.vjp`` of flax ``GroupNorm`` -> swish
(what XLA differentiates when the JAX package trains), on the same seeded
numpy inputs; the autograd Function that ``GroupNormSiLU`` runs; and the
CUDA kernel's plan (``nchw_backward_plan``) and order of summation, which
run here without a card: the plan's constants against
``csrc/gn_silu_bwd.cu``, its cover of every element at the flagship's sites
and odd shapes, and a float32 transcription of the kernel's sums held
against the plain version.

Tolerances, as max |d| against the largest |reference| of each output
(``scale``): float32 dx 2e-6 of scale, dweight and dbias 2e-6 (the sums are
taken in other orders; the closed form's three means cancel to a few f32 ulps
of the scale); bfloat16 dx one bf16 ulp (2**-7 relative) plus 2e-6 of the
scale, where either side may round the same f32 value the other way.
Against JAX in bfloat16, dx also takes one bf16 ulp of the scale: x feeds
flax's statistics and its normalisation through separate casts, and JAX adds
the cotangents of those uses in x's dtype, so its bf16 dx is a sum of
bf16-rounded terms (its own float32 gradient, rounded once, differs from it
by up to one ulp of the scale's binade).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sddm_tpu_torch import compare_gn_silu_backward
from sddm_tpu_torch.models import blocks
from sddm_tpu_torch.models.blocks import GroupNormSiLU
from sddm_tpu_torch.ops import gn_silu as ops
from sddm_tpu_torch.ops.gn_silu import (
    GroupNormSiLUFunction,
    gn_silu,
    gn_silu_backward,
    gn_silu_backward_reference,
    gn_silu_reference,
    nchw_backward_plan,
)

# (B, C, H, W, G): channels per group 1, 2 and 3; B 1 and 3; odd H * W
SHAPES = [
    (3, 8, 4, 6, 8),
    (1, 8, 5, 7, 4),
    (3, 12, 3, 5, 4),
    (1, 6, 8, 4, 2),
]
BF16_ULP = 2.0**-7
REL = 2e-6


def _inputs(shape, seed):
    b, c, h, w, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, h, w)) * 2.0 + 0.5).astype(np.float32)
    dy = rng.standard_normal((b, c, h, w)).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, dy, weight, bias


def _autograd(x, dy, weight, bias, groups, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(weight).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    gn_silu_reference(xt, wt, bt, groups).backward(torch.from_numpy(dy).to(dtype))
    return xt.grad, wt.grad, bt.grad


def _plain(x, dy, weight, bias, groups, dtype):
    out = gn_silu_backward_reference(torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype),
                                     torch.from_numpy(weight), torch.from_numpy(bias), groups)
    assert out[0].dtype == dtype and out[1].dtype == out[2].dtype == torch.float32
    return out


def _jax_vjp(x, dy, weight, bias, groups, dtype):
    """flax GroupNorm(dtype=float32) -> swish -> astype(x.dtype) on NHWC, as
    sddm_tpu/models/blocks.py::Block runs it, differentiated by jax.vjp."""
    gn = nn.GroupNorm(num_groups=groups, epsilon=1e-5, dtype=jnp.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def f(xn, scale, b):
        h = gn.apply({"params": {"scale": scale, "bias": b}}, xn)
        return jax.nn.silu(h).astype(xn.dtype)

    xn = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    _, vjp = jax.vjp(f, xn, jnp.asarray(weight), jnp.asarray(bias))
    dx, dw, db = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)).astype(jdt))
    dx = np.asarray(dx.astype(jnp.float32)).transpose(0, 3, 1, 2)
    return tuple(torch.from_numpy(np.array(a)) for a in (dx, dw, db))


def _hold(got, want, dtype, bf16_scale_ulp=False):
    for name, g, w in zip(("dx", "dweight", "dbias"), got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        bf16_dx = name == "dx" and dtype == torch.bfloat16
        rtol = BF16_ULP if bf16_dx else 0.0
        atol = (BF16_ULP if bf16_dx and bf16_scale_ulp else REL) * scale
        err = (g - w).abs()
        assert bool(torch.all(err <= atol + rtol * w.abs())), \
            f"{name}: max|d| {float(err.max()):.3e} at scale {scale:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_torch_autograd(shape, dtype):
    x, dy, weight, bias = _inputs(shape, sum(shape))
    _hold(_plain(x, dy, weight, bias, shape[-1], dtype),
          _autograd(x, dy, weight, bias, shape[-1], dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_jax_vjp_of_flax(shape, dtype):
    x, dy, weight, bias = _inputs(shape, 7 * sum(shape))
    _hold(_plain(x, dy, weight, bias, shape[-1], dtype),
          _jax_vjp(x, dy, weight, bias, shape[-1], dtype), dtype, bf16_scale_ulp=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_constant_group(dtype):
    """A run of one value whose sum is exact: ``mean`` is that value, xhat is
    0, so dweight gets nothing from it and dx = r (dz w - mean(dz w)),
    whether or not E[x^2] - mean^2 rounds below 0 (torch autograd passes no
    gradient through clamp_min there; the closed form drops the same
    term).  The other groups of the call are ordinary."""
    x, dy, weight, bias = _inputs((2, 8, 4, 4, 4), 3)
    x[:, 2:4] = 1000.0  # group 1 of both rows: 32 elements of 1000, sum exact
    got = _plain(x, dy, weight, bias, 4, dtype)
    want = _autograd(x, dy, weight, bias, 4, dtype)
    _hold(got, want, dtype)
    assert float(got[1][2:4].abs().max()) == 0.0  # dweight of the constant group's channels
    assert torch.isfinite(got[0]).all()


def test_function_gradcheck_float64():
    """The autograd Function on the CPU (both directions on their plain
    versions, computed in float64 for a float64 input) against numerical
    differences."""
    rng = np.random.default_rng(11)
    for b, c, h, w, g in ((2, 6, 3, 5, 3), (1, 4, 4, 3, 2), (3, 4, 2, 3, 4)):
        x = torch.from_numpy(rng.standard_normal((b, c, h, w))).requires_grad_()
        wt = torch.from_numpy(rng.uniform(0.5, 1.5, c)).requires_grad_()
        bt = torch.from_numpy(0.3 * rng.standard_normal(c)).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda *a: GroupNormSiLUFunction.apply(*a, g, 1e-5), (x, wt, bt))


def test_cpu_wrapper_is_the_plain_version():
    x, dy, weight, bias = _inputs((3, 12, 3, 5, 4), 5)
    args = (torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(weight),
            torch.from_numpy(bias), 4)
    before = gn_silu_backward.launches
    for got, want in zip(gn_silu_backward(*args), gn_silu_backward_reference(*args)):
        assert torch.equal(got, want)
    assert gn_silu_backward.launches == before  # the count is the kernel's alone
    with pytest.raises(ValueError, match="cuda or cpu"):
        gn_silu_backward(*(a.to("meta") if torch.is_tensor(a) else a for a in args))


def test_module_records_through_the_function(monkeypatch):
    """``GroupNormSiLU`` runs the forward and backward its module names
    (``blocks.gn_silu``, ``blocks.gn_silu_backward``, which a caller may
    route to the plain versions) where autograd records, and only the
    forward under ``torch.no_grad()``."""
    calls = []

    def fwd(*a):
        calls.append("forward")
        return gn_silu(*a)

    def bwd(*a):
        calls.append("backward")
        return gn_silu_backward(*a)

    monkeypatch.setattr(blocks, "gn_silu", fwd)
    monkeypatch.setattr(blocks, "gn_silu_backward", bwd)
    mod = GroupNormSiLU(4, 8)
    x = torch.randn(2, 8, 3, 5, requires_grad=True)
    with torch.no_grad():
        y0 = mod(x)
    assert calls == ["forward"] and y0.grad_fn is None
    y = mod(x)
    assert y.grad_fn is not None
    y.sum().backward()
    assert calls == ["forward", "forward", "backward"]
    assert torch.equal(y.detach(), y0)
    want = gn_silu_backward_reference(x.detach(), torch.ones_like(y), mod.weight.detach(),
                                      mod.bias.detach(), 4)
    for got, ref in zip((x.grad, mod.weight.grad, mod.bias.grad), want):
        assert torch.equal(got, ref)


# -- the run kernel's plan and order of summation ------------------------------------

# The 19 distinct GroupNorm sites (C, H, W, G) of the flagship's plain network,
# as chip_smoke.py phase [3] lists them for artifacts/flagship_synth.
FLAGSHIP_SITES = list(compare_gn_silu_backward.FLAGSHIP_SITES)
# phase [23]'s edge cases (C, H, W, G) and odd shapes: cg 3 with H*W = 35
# (one element a load), a constant group, the 5.2M-element run, channels that
# cross slice boundaries on a cluster, the one-element path on a cluster
ODD_SITES = [(12, 7, 5, 4), (16, 8, 8, 4), (4, 1024, 2560, 2), (6, 37, 40, 2), (8, 129, 129, 4)]
SMS = 132  # an H100's SMs
SMEM_PER_CTA = 232448  # what an H100 CTA may take, static and dynamic


def test_nchw_backward_plan_constants_match_the_kernel_source():
    """The plan's copies of the kernel's CTA size, cluster size, shared
    memory ceiling and channel chunk, and the ceiling within what an H100
    CTA may take beside the kernel's static arrays."""
    import re

    src = ops.BACKWARD_SOURCE.read_text()
    for name, value in (("kThreadsB", ops._THREADS_B), ("kClusterB", ops._CLUSTER_B),
                        ("kSmemMaxB", ops._SMEM_MAX_B), ("kChunkB", ops._CHUNK_B)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value
    warps = ops._THREADS_B // 32
    # red, cred, msum, stat, last_run
    static = 4 * (2 * warps + 2 * ops._CHUNK_B * warps + 2 * warps + 2 + warps)
    for decl in ("float red[2][kThreadsB / 32]", "float cred[2][kChunkB][kThreadsB / 32]",
                 "float msum[kThreadsB / 32][2]", "float stat[2]",
                 "int last_run[kThreadsB / 32]"):
        assert f"__shared__ {decl};" in src
    assert src.count("__shared__") == 6  # the five above and the dynamic stage
    assert ops._SMEM_MAX_B + static <= SMEM_PER_CTA
    assert "gn_silu_bwd_run" in src  # chip_smoke.py's profiler filter: gn_silu_bwd


def _bwd_slices(p, units):
    """Each rank's slice [lo, mid, hi) of a run: kept units [lo, mid), read
    again [mid, hi)."""
    out = []
    for rank in range(p.q):
        lo, hi = rank * p.slice, min(units, (rank + 1) * p.slice)
        out.append((lo, min(hi, lo + p.cap), hi))
    return out


def _bwd_coverage(p, units, upc):
    """How often the kernel's index maps, transcribed, visit each unit of a
    run: pass 1 (thread j of a rank takes units lo + j + m * tpr of [lo, mid)
    and then of [mid, hi)) and passes 2-3 (units a + j + m * tpr of each
    channel [a, b) of the slice, its kept part first); and, per channel, the
    ranks that write its partials against those its group's sum reads."""
    tpr = p.threads // p.runs
    first_pass = np.zeros(units, np.int64)
    channel_pass = np.zeros(units, np.int64)
    offsets = set()
    writers = {}
    for rank, (lo, mid, hi) in enumerate(_bwd_slices(p, units)):
        assert lo < hi, f"rank {rank} of {p} has no units"
        for start, stop in ((lo, mid), (mid, hi)):
            for j in range(tpr):
                np.add.at(first_pass, np.arange(start + j, stop, tpr), 1)
        offsets.update(range(mid - lo))
        for k in range(lo // upc, (hi - 1) // upc + 1):
            ca, cb = max(lo, k * upc), min(hi, (k + 1) * upc)
            assert ca < cb
            writers.setdefault(k, []).append(rank)
            for start, stop in ((ca, min(cb, mid)), (max(ca, mid), cb)):
                for j in range(tpr):
                    np.add.at(channel_pass, np.arange(start + j, stop, tpr), 1)
    for k, ranks in writers.items():  # sum_group reads ranks first..last
        first, last = k * upc // p.slice, ((k + 1) * upc - 1) // p.slice
        assert ranks == list(range(first, last + 1)), (k, ranks)
    return first_pass, channel_pass, offsets


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 16, 200])
def test_nchw_backward_plan_covers_every_element_once_and_fits_the_card(b, elem):
    for c, h, w, g in FLAGSHIP_SITES + ODD_SITES:
        hw, pack = h * w, 16 // elem
        for vec in sorted({hw % pack == 0, False}):
            p = nchw_backward_plan(b, c, hw, g, elem, vec, SMS)
            where = f"[{b}, {c}, {h}, {w}] G={g} elem {elem} vec {vec}: {p}"
            pk = pack if vec else 1
            unit, upc = pk * elem, hw // pk
            units = c // g * upc
            tpr = p.threads // p.runs
            assert p.q in (1, 2, 4, 8), where
            assert 32 <= p.threads <= 512 and p.threads % p.runs == 0 and tpr % 32 == 0, where
            assert p.q == 1 or p.runs == 1, where
            assert p.runs <= p.threads // 32, where  # msum holds a run per warp
            assert p.grid % p.q == 0 and p.grid == -(-b * g // p.runs) * p.q, where
            owner = np.arange(b * g) // p.runs
            assert np.bincount(owner).min() >= 1 and owner.max() == p.grid // p.q - 1, where
            assert units * pk == c // g * hw, where
            first_pass, channel_pass, offsets = _bwd_coverage(p, units, upc)
            assert (first_pass == 1).all() and (channel_pass == 1).all(), where
            # shared memory: `runs` slots of `cap` units of x, then as many of
            # dy; the rest of a slice is read again
            assert p.slice == -(-units // p.q), where
            assert max(offsets) < p.cap and p.reread == p.slice - p.cap >= 0, where
            assert p.cap == min(p.slice, 229376 // (2 * p.runs * unit)), where
            assert p.smem == 2 * p.runs * p.cap * unit <= 229376, where
            assert p.packs == -(-p.cap // tpr), where
            assert p.q * p.cap >= units or p.reread > 0, where


def test_nchw_backward_plan_at_the_flagship_sites():
    """Batch 16 in bf16: every flagship run is read once (no reread), the
    largest two sites' runs (128 and 64 KB of x) split across clusters of 4
    and 2 CTAs of 32 KB of x each, and the small runs share a CTA while
    every SM keeps one, a warp a run at the smallest."""
    plans = {s: nchw_backward_plan(16, s[0], s[1] * s[2], s[3], 2, True, SMS)
             for s in FLAGSHIP_SITES}
    assert all(p.reread == 0 for p in plans.values())
    big = plans[(64, 256, 128, 32)]
    assert (big.q, big.threads, big.slice, big.cap, big.smem, big.grid) == \
        (4, 256, 2048, 2048, 65536, 512 * 4)
    assert plans[(32, 256, 128, 32)].q == plans[(128, 128, 64, 32)].q == 2
    small = plans[(160, 8, 4, 32)]
    assert small.q == 1 and small.runs == 2 and small.threads // small.runs == 32
    assert small.grid == 512 // 2 and small.slice == 20
    assert all(p.grid >= SMS and (p.runs == 1 or p.grid // 2 < SMS) for p in plans.values())
    assert sum(p.q > 1 for p in plans.values()) == 3


def test_nchw_backward_plan_rereads_a_run_larger_than_a_cluster_holds():
    for elem in (2, 4):
        p = nchw_backward_plan(2, 4, 1024 * 2560, 2, elem, True, SMS)
        run_bytes = 2 * 1024 * 2560 * elem
        assert p.q == 8 and p.reread > 0 and p.smem == 229376 and p.grid == 4 * 8  # 4 runs
        assert run_bytes >= 8 * p.q * p.cap * 16  # x alone: over 8 times what a cluster keeps


def _tree(v):
    """Per warp of ``v`` (threads, last axis) the kernel's xor-shuffle tree;
    returns the warps' sums, in warp order."""
    lanes = np.arange(32)
    v = v.reshape(v.shape[:-1] + (-1, 32))
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _in_order(sums, f32=np.float32):
    """0 + sums[0] + sums[1] + ... in float32, over the last axis."""
    acc = np.zeros(sums.shape[:-1], f32)
    for i in range(sums.shape[-1]):
        acc = (acc + sums[..., i]).astype(f32)
    return acc


def _thread_steps(start, stop, tpr):
    """Thread j's units start + j + m * tpr below stop, as (m, j) indices and
    a mask, in each thread's order."""
    steps = max(0, -(-(stop - start) // tpr))
    idx = start + np.arange(tpr)[None, :] + tpr * np.arange(steps)[:, None]
    return np.where(idx < stop, idx, 0), idx < stop


def _bwd_kernel_order(x, dy, weight, bias, groups, sms, eps=1e-5):
    """The kernel's order of summation, its groups' last sums included,
    transcribed in float32 (the kernel's fused multiply-adds rounded as two
    operations): pass 1 per thread its kept units, then its reread ones, a
    pack's elements in order, a warp xor tree, the run's warps in order, the
    ranks in order; pass 2 per channel of a slice the same for dz and dz
    xhat, then per chunk of channels a warp tree of w times the channel
    sums, then the ranks; dweight, dbias per row over the ranks holding the
    channel, then over rows.  Returns (dx, dweight, dbias, (mean, v) per
    run)."""
    f32 = np.float32
    b, c, h, w = x.shape
    hw, pack, elem = h * w, 16 // x.element_size(), x.element_size()
    vec = hw % pack == 0
    p = nchw_backward_plan(b, c, hw, groups, elem, vec, sms)
    pk = pack if vec else 1
    tpr, cg, upc = p.threads // p.runs, c // groups, hw // pack if vec else hw
    runs = b * groups
    xr = x.float().numpy().reshape(runs, -1, pk)
    gr = dy.float().numpy().reshape(runs, -1, pk)
    wn, bn = weight.numpy().astype(f32), bias.numpy().astype(f32)
    n = cg * hw
    units = n // pk
    slices = _bwd_slices(p, units)
    dx = np.empty((runs, units, pk), f32)
    part = np.zeros((2, b, c, p.q), f32)
    mean_of, v_of = np.empty(runs, f32), np.empty(runs, f32)
    for run in range(runs):
        row, grp = divmod(run, groups)
        xu, gu = xr[run], gr[run]
        cta = []
        for lo, mid, hi in slices:
            s, ss = np.zeros(tpr, f32), np.zeros(tpr, f32)
            for start, stop in ((lo, mid), (mid, hi)):
                idx, ok = _thread_steps(start, stop, tpr)
                for m in range(idx.shape[0]):
                    for e in range(pk):
                        val = xu[idx[m], e]
                        s = np.where(ok[m], s + val, s)
                        ss = np.where(ok[m], ss + val * val, ss)
            cta.append([_in_order(_tree(s)), _in_order(_tree(ss))])
        s, ss = _in_order(np.array(cta, f32).T)
        mean = f32(s / f32(n))
        v = f32(f32(ss / f32(n)) - f32(mean * mean))
        mean_of[run], v_of[run] = mean, v
        rstd = f32(1.0 / np.sqrt(np.float64(max(v, f32(0)) + f32(eps))))
        chan = slice(grp * cg, (grp + 1) * cg)
        wg, bg = wn[chan], bn[chan]

        def dz_xh(k, idx):
            d = (xu[idx] - mean).astype(f32)
            aw = f32(rstd * wg[k])
            y = (d * aw + bg[k]).astype(f32)
            sg = (f32(1) / (f32(1) + np.exp(-y))).astype(f32)
            dz = (gu[idx] * sg * (f32(1) + y * (f32(1) - sg))).astype(f32)
            return dz, (d * rstd).astype(f32)

        msums = []
        for rank, (lo, mid, hi) in enumerate(slices):
            kfirst, klast = lo // upc, (hi - 1) // upc
            mdz = mdzx = f32(0)
            for k0 in range(kfirst, klast + 1, ops._CHUNK_B):
                ks = range(k0, min(klast + 1, k0 + ops._CHUNK_B))
                lane_dz, lane_dzx = np.zeros(32, f32), np.zeros(32, f32)
                for kk, k in enumerate(ks):
                    ca, cb = max(lo, k * upc), min(hi, (k + 1) * upc)
                    sdz, sdzx = np.zeros(tpr, f32), np.zeros(tpr, f32)
                    for start, stop in ((ca, min(cb, mid)), (max(ca, mid), cb)):
                        idx, ok = _thread_steps(start, stop, tpr)
                        for m in range(idx.shape[0]):
                            dz, xh = dz_xh(k, idx[m])
                            for e in range(pk):
                                sdz = np.where(ok[m], sdz + dz[:, e], sdz)
                                sdzx = np.where(ok[m], sdzx + dz[:, e] * xh[:, e], sdzx)
                    pdz, pdzx = _in_order(_tree(sdz)), _in_order(_tree(sdzx))
                    part[0, row, grp * cg + k, rank] = pdzx
                    part[1, row, grp * cg + k, rank] = pdz
                    lane_dz[kk], lane_dzx[kk] = wg[k] * pdz, wg[k] * pdzx
                mdz = f32(mdz + _tree(lane_dz)[0])
                mdzx = f32(mdzx + _tree(lane_dzx)[0])
            msums.append([mdz, mdzx])
        mdz, mdzx = _in_order(np.array(msums, f32).T)
        m1 = f32(mdz / f32(n))
        m2 = f32(mdzx / f32(n)) if v >= 0 else f32(0)
        for k in range(cg):
            idx = np.arange(k * upc, (k + 1) * upc)
            dz, xh = dz_xh(k, idx)
            dx[run, idx] = rstd * (dz * wg[k] - m1 - xh * m2)
    dweight, dbias = np.zeros(c, f32), np.zeros(c, f32)
    for ch in range(c):
        k = ch % cg
        first, last = k * upc // p.slice, ((k + 1) * upc - 1) // p.slice
        per_row = _in_order(part[:, :, ch, first:last + 1])  # [2, B]
        dweight[ch], dbias[ch] = _in_order(per_row)
    dx = torch.from_numpy(dx.reshape(x.shape)).to(x.dtype)
    return dx, torch.from_numpy(dweight), torch.from_numpy(dbias), (mean_of, v_of)


def _closed_form(x, dy, weight, bias, groups, mean, v, eps=1e-5):
    """The closed-form gradient in float64 at given per-run statistics
    (``mean``, ``v``): where ``v < 0`` the xhat term of dx is dropped."""
    b, c = x.shape[:2]
    cg = c // groups
    xg = x.astype(np.float64).reshape(b, groups, cg, -1)
    mean = mean.astype(np.float64).reshape(b, groups, 1, 1)
    v = v.astype(np.float64).reshape(b, groups, 1, 1)
    r = 1.0 / np.sqrt(np.maximum(v, 0.0) + eps)
    w = weight.astype(np.float64).reshape(1, groups, cg, 1)
    xhat = (xg - mean) * r
    y = xhat * w + bias.astype(np.float64).reshape(1, groups, cg, 1)
    s = 1.0 / (1.0 + np.exp(-y))
    dz = dy.astype(np.float64).reshape(xg.shape) * s * (1 + y * (1 - s))
    m1 = (dz * w).mean(axis=(2, 3), keepdims=True)
    m2 = np.where(v < 0, 0.0, (dz * w * xhat).mean(axis=(2, 3), keepdims=True))
    dx = r * (dz * w - m1 - xhat * m2)
    dweight, dbias = (dz * xhat).sum(axis=(0, 3)).reshape(c), dz.sum(axis=(0, 3)).reshape(c)
    return tuple(torch.from_numpy(a) for a in (dx.reshape(x.shape), dweight, dbias))


@pytest.mark.parametrize("shape,groups,sms,dtype", [
    ((1, 6, 37, 40), 2, SMS, torch.float32),    # q = 4; slices cross channel boundaries
    ((1, 4, 64, 128), 2, SMS, torch.bfloat16),  # q = 8; 16-byte packs of 8
    ((8, 160, 8, 4), 32, 64, torch.float32),    # a warp a run, four runs a CTA
    ((1, 1, 1024, 1280), 1, SMS, torch.float32),  # a slice over shared memory: the reread
    ((1, 8, 129, 129), 4, SMS, torch.float32),  # one element a load, q = 8
    ((2, 12, 16, 16), 3, 4, torch.bfloat16),   # several warps a run on a 4-SM card
], ids=["q4-cross", "q8-bf16", "warp-runs", "reread", "unaligned", "warps"])
def test_nchw_backward_kernel_order_matches_the_plain_version(shape, groups, sms, dtype):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1]).astype(np.float32))
    bias = torch.from_numpy((0.2 * rng.standard_normal(shape[1])).astype(np.float32))
    got = _bwd_kernel_order(x, dy, weight, bias, groups, sms)
    _hold(got[:3], gn_silu_backward_reference(x, dy, weight, bias, groups), dtype)


@pytest.mark.parametrize("shape,value", [((2, 8, 4, 4, 4), 1000.0), ((2, 8, 6, 6, 4), 7.7)],
                         ids=["exact", "v-below-0"])
def test_nchw_backward_kernel_order_of_a_constant_group(shape, value):
    """A group of one value: with 1000 the sums are exact, xhat is 0 and its
    channels get no dweight, against torch autograd.  72 elements of 7.7
    make E[x^2] - mean^2 round below 0 in the kernel's order, so the xhat
    term of dx is dropped (torch autograd passes no gradient through
    clamp_min there); the mean then misses 7.7 by an ulp, and with r =
    rsqrt(eps) the gradient moves by 1e-4 of its scale with that ulp, so
    this case is held against the closed form in float64 at the
    transcription's own statistics."""
    x, dy, weight, bias = _inputs(shape, 3)
    x[:, 2:4] = value
    args = (torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(weight),
            torch.from_numpy(bias), 4)
    dx, dweight, dbias, (mean, v) = _bwd_kernel_order(*args, SMS)
    if value == 1000.0:
        assert (v[1::4] == 0).all() and (mean[1::4] == value).all()
        _hold((dx, dweight, dbias), _autograd(x, dy, weight, bias, 4, torch.float32),
              torch.float32)
        assert float(dweight[2:4].abs().max()) == 0.0
    else:
        assert (v[1::4] < 0).all() and (v[0::4] > 0).all()
        _hold((dx, dweight, dbias), _closed_form(x, dy, weight, bias, 4, mean, v),
              torch.float32)
    assert ops.BACKWARD_SOURCE.name == "gn_silu_bwd.cu" and ops.BACKWARD_SOURCE.is_file()


def test_the_site_comparison_lists_a_train_steps_sites_and_needs_a_card(tmp_path):
    """The comparison script's sites: 19 distinct, 33 calls a train step (two
    sites four and three times); the earlier design's CTA sizes; and, with
    no card, an exit code of 2 before anything is built."""
    sites = compare_gn_silu_backward.FLAGSHIP_SITES
    assert len(sites) == 19 and sum(sites.values()) == 33
    assert all(g == 32 and c % g == 0 for c, h, w, g in sites)
    assert [compare_gn_silu_backward.earlier_threads(hw) for hw in (1, 32, 33, 32768)] == \
        [32, 32, 64, 512]
    assert not torch.cuda.is_available()
    assert compare_gn_silu_backward.main(["--earlier", str(tmp_path / "none.cu")]) == 2
