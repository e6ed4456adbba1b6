"""Fused GroupNorm + SiLU: the CUDA kernels of ``csrc/gn_silu.cu`` and their
plain PyTorch versions, in two layouts.

- :func:`gn_silu`, NCHW: counterpart of
  ``sddm_tpu/experimental/pallas_groupnorm_swish.py`` (``group_norm_swish``)
  and of the flax ``GroupNorm`` -> swish prologue of
  ``sddm_tpu/models/blocks.py::Block``.  A (batch row, group) is one
  contiguous run of ``C / G * H * W`` values.  One launch per call, a large
  run split across a thread-block cluster; its plan is :func:`nchw_plan`.
- :func:`gn_silu_nhwc`, NHWC ``[B, H, W, C4]``: counterpart of
  ``sddm_tpu/experimental/pallas_gn_silu.py`` (``gn_silu``), the
  ``_GN`` -> silu (-> offset mask) chain of the packed engine
  (``sddm_tpu/models/unet_packed.py``), with a channel -> group map in place
  of the Pallas kernel's one-hot matrix.  One cooperative launch per call;
  its grid plan is :func:`nhwc_plan`.

The NCHW function has a backward too: :func:`gn_silu_backward`, the kernel
of ``csrc/gn_silu_bwd.cu`` (no TPU counterpart: JAX differentiates flax's
GroupNorm -> swish through XLA), with its plain version
:func:`gn_silu_backward_reference`; :class:`GroupNormSiLUFunction` joins the
two directions for autograd.

The kernels are compiled at first use with ``nvcc`` into ``_build/`` inside
this package (git-ignored) and loaded with ``ctypes``; a CPU tensor takes
the plain version instead, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .cuda_build import CSRC, CudaLibrary
from .packed import offset_mask

SOURCE = CSRC / "gn_silu.cu"
_NCHW_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
              + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_NHWC_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
              + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_LIB = CudaLibrary(SOURCE, {
    "gn_silu_f32": _NCHW_ARGS, "gn_silu_bf16": _NCHW_ARGS,
    "gn_silu_nhwc_f32": _NHWC_ARGS, "gn_silu_nhwc_bf16": _NHWC_ARGS,
    "gn_silu_nchw_max_clusters": [ctypes.c_int] * 5 + [ctypes.c_void_p],
})
BACKWARD_SOURCE = CSRC / "gn_silu_bwd.cu"
_BWD_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_BWD_LIB = CudaLibrary(BACKWARD_SOURCE, {"gn_silu_bwd_f32": _BWD_ARGS,
                                         "gn_silu_bwd_bf16": _BWD_ARGS})
_MAX_CHANNELS, _MAX_GROUPS = 4096, 1024  # the NHWC statistics' shared memory
# The NHWC kernel's constants (csrc/gn_silu.cu: kThreadsN, kSmemMaxN): one block
# of 512 threads per SM, 227 KB of shared memory a block.
_THREADS_N, _SMEM_MAX = 512, 232448
_MIN_RANGE_BYTES = 16384  # a range of positions is split no finer than this
# The NCHW kernel's constants (csrc/gn_silu.cu: kThreadsC, kClusterC, kSmemMaxC):
# at most 512 threads a CTA and 8 CTAs a cluster; the shared memory a CTA keeps
# its slice in, at most.
_THREADS_C, _CLUSTER_C, _SMEM_MAX_C = 512, 8, 231424
# The NCHW plan, in units (what one load moves: a 16-byte pack, or one
# element): a run of more than _SLICE_UNITS is split across a cluster, at
# most _SLICE_UNITS a CTA where 8 CTAs suffice; a run is spread further
# across a card that would otherwise idle, down to _MIN_SLICE_UNITS a CTA.  A
# slice of up to 256 units takes a thread for every 2, up to 1024 for every
# 4, a larger one for every 8, whole warps up to 512 threads (the fastest
# of the plans timed at the flagship's sites on an H100); small runs share a
# CTA up to _CTA_THREADS.
_SLICE_UNITS, _MIN_SLICE_UNITS, _CTA_THREADS = 4096, 256, 256
# The NCHW backward's constants (csrc/gn_silu_bwd.cu: kThreadsB, kClusterB,
# kSmemMaxB, kChunkB): at most 512 threads a CTA and 8 CTAs a cluster; the
# shared memory a CTA keeps its slice of x and dy in, at most; the channels
# whose sums a CTA meets at once.  A slice holds x and dy, so a run of more
# than _BWD_SLICE_UNITS (32 KB of x) goes to a cluster (the fastest of 1024,
# 2048 and 4096 timed at the flagship's sites on an H100).
_THREADS_B, _CLUSTER_B, _SMEM_MAX_B, _CHUNK_B = 512, 8, 229376, 16
_BWD_SLICE_UNITS = 2048


def build() -> dict:
    """Compile ``csrc/gn_silu.cu``, both layouts (see :func:`cuda_build.build`)."""
    return _LIB.build()


def build_backward() -> dict:
    """Compile ``csrc/gn_silu_bwd.cu``, the NCHW backward."""
    return _BWD_LIB.build()


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 input (which ``gradcheck`` uses)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def gn_silu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch GroupNorm + SiLU with flax's arithmetic: f32 statistics,
    ``var = max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, ``y * sigmoid(y)``, cast back to ``x.dtype`` (a float64
    input is computed in float64)."""
    b, c = x.shape[:2]
    ct = _compute_dtype(x)
    xg = x.to(ct).reshape(b, num_groups, c // num_groups, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    shape = (1, num_groups, c // num_groups, 1)
    mul = torch.rsqrt(var + eps) * weight.to(ct).reshape(shape)
    y = (xg - mean) * mul + bias.to(ct).reshape(shape)
    y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def gn_silu_backward_reference(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """Plain PyTorch gradient of :func:`gn_silu_reference`, in closed form:
    ``(dx, dweight, dbias)``, dx in ``x.dtype``, the others f32 (f64 for a
    float64 input).  Per run (batch row, group), with the forward's ``mean``,
    ``v = E[x^2] - mean^2``, ``r = rsqrt(max(v, 0) + eps)``, ``xhat = (x -
    mean) r``, ``y = (x - mean) (r w) + b``, ``s = sigmoid(y)``:
    ``dz = dy s (1 + y (1 - s))``, ``dbias = sum dz``, ``dweight = sum dz
    xhat`` (over batch and positions), ``dx = r (dz w - mean(dz w) - xhat
    mean(dz w xhat))``.  Where ``v < 0`` the last term is dropped, because
    ``clamp_min`` passes no gradient there: torch autograd of the reference
    gives the same.  A constant run whose sum is exact has ``mean`` equal to
    the constant and ``xhat = 0``, so ``dweight`` gets nothing from it and
    ``dx = r (dz w - mean(dz w))`` whether or not ``v`` rounds below 0."""
    b, c = x.shape[:2]
    cg = c // num_groups
    ct = _compute_dtype(x)
    xg = x.to(ct).reshape(b, num_groups, cg, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
    v = mean2 - mean * mean
    r = torch.rsqrt(torch.clamp_min(v, 0.0) + eps)
    shape = (1, num_groups, cg, 1)
    w = weight.to(ct).reshape(shape)
    y = (xg - mean) * (r * w) + bias.to(ct).reshape(shape)
    xhat = (xg - mean) * r
    s = torch.sigmoid(y)
    dz = dy.to(ct).reshape(xg.shape) * s * (1 + y * (1 - s))
    dbias = dz.sum(dim=(0, 3)).reshape(c)
    dweight = (dz * xhat).sum(dim=(0, 3)).reshape(c)
    dzw = dz * w
    m1 = dzw.mean(dim=(2, 3), keepdim=True)
    m2 = torch.where(v < 0, 0.0, (dzw * xhat).mean(dim=(2, 3), keepdim=True))
    dx = r * (dzw - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dweight, dbias


def _check(x, weight, bias, num_groups):
    if x.dim() != 4:
        raise ValueError(f"gn_silu takes NCHW input, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gn_silu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_silu needs a contiguous NCHW input")
    b, c, h, w = x.shape
    if x.numel() == 0 or c % num_groups != 0:
        raise ValueError(f"bad shape {tuple(x.shape)} for {num_groups} groups")
    if h * w >= 2**31 or b * num_groups >= 2**31 or c // num_groups * h * w >= 2**31 - 2**13:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int32 sizes")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, input on {x.device}")


class NchwPlan(NamedTuple):
    """The launch of one :func:`gn_silu` call (``csrc/gn_silu.cu``,
    ``gn_silu_nchw``).  A run (one batch row's group) is ``cg * H * W /
    pack`` units: loads of 16 bytes, or of one element where the 16-byte
    path does not apply.  With ``q > 1`` the ``q`` CTAs of cluster ``r``
    split run ``r`` into slices of ``slice`` units (the last may be
    shorter); with ``q == 1`` CTA ``i`` takes ``runs`` consecutive runs,
    ``threads / runs`` threads each.  A CTA keeps the first ``cap`` units of
    each of its slices in shared memory, ``packs`` units a thread, and reads
    the ``reread`` units after them from device memory twice."""

    q: int          # CTAs of a cluster: 1, 2, 4 or 8
    threads: int    # threads of a CTA
    runs: int       # runs of a CTA (q == 1 only)
    grid: int       # CTAs launched, a whole number of clusters
    smem: int       # dynamic shared memory of a CTA, bytes
    slice: int      # units of a CTA's slice of its run
    cap: int        # units of a slice kept in shared memory
    packs: int      # units a thread keeps in shared memory
    reread: int     # units of a slice read twice: slice - cap


@functools.lru_cache(maxsize=512)
def nchw_plan(b: int, c: int, hw: int, g: int, elem: int, vec: bool, sms: int) -> NchwPlan:
    """The plan of one NCHW call of ``b`` rows, ``c`` channels, ``hw``
    positions and ``g`` groups, elements of ``elem`` bytes, on a card of
    ``sms`` SMs.  ``vec``: the kernel moves 16-byte packs (else one element
    a load).  A run of more than ``_SLICE_UNITS`` goes to a cluster of q
    CTAs, the fewest that bring a slice to ``_SLICE_UNITS`` (at most 8);
    fewer runs than SMs spread over more CTAs, none under
    ``_MIN_SLICE_UNITS``; a thread takes 2, 4 or 8 units of a slice, more
    of a larger one, and small runs share a CTA while the card keeps a CTA
    on each SM.  A CTA keeps its slices in shared memory up to
    ``_SMEM_MAX_C`` bytes; what does not fit is read twice."""
    pack = 16 // elem if vec else 1
    unit = pack * elem
    units = c // g * hw // pack
    runs = b * g
    q = 1
    while q < _CLUSTER_C and -(-units // q) > _SLICE_UNITS:
        q *= 2
    while q < _CLUSTER_C and runs * q < sms and -(-units // (2 * q)) >= _MIN_SLICE_UNITS:
        q *= 2
    sl = -(-units // q)
    per_thread = 2 if sl <= 256 else 4 if sl <= 1024 else 8
    tpr = min(_THREADS_C, -(-sl // (32 * per_thread)) * 32)
    rpc = 1
    if q == 1:
        while 2 * rpc * tpr <= _CTA_THREADS and -(-runs // (2 * rpc)) >= sms:
            rpc *= 2
    cap = min(sl, _SMEM_MAX_C // (rpc * unit))
    return NchwPlan(q, tpr * rpc, rpc, -(-runs // rpc) * q, rpc * cap * unit, sl, cap,
                    -(-cap // tpr), sl - cap)


def nchw_max_clusters(plan: NchwPlan, elem: int, vec: bool) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan``'s kernel and cluster
    size on the current card (``plan.q > 1``)."""
    n = ctypes.c_int(0)
    rc = _LIB.get().gn_silu_nchw_max_clusters(elem, int(vec), plan.threads, plan.q, plan.smem,
                                              ctypes.addressof(n))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {rc} ({plan})")
    return n.value


def gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)) for NCHW ``x`` (f32 or bf16) with f32 ``weight``
    and ``bias`` of shape ``[C]``.  CUDA tensors run the kernel, one launch
    planned by :func:`nchw_plan`; ``gn_silu.launches`` counts its launches."""
    if x.device.type == "cpu":
        return gn_silu_reference(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu runs on cuda or cpu, not {x.device}")
    _check(x, weight, bias, num_groups)
    lib = _LIB.get()
    fn = lib.gn_silu_bf16 if x.dtype == torch.bfloat16 else lib.gn_silu_f32
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    elem = x.element_size()
    vec = (h * w) % (16 // elem) == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    plan = nchw_plan(b, c, h * w, num_groups, elem, vec, _sm_count(x.device))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                b, c, h * w, num_groups, eps, plan.q, plan.threads, plan.runs, plan.cap,
                plan.grid, plan.smem, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu kernel launch failed: CUDA error {rc} (plan {plan})")
    gn_silu.launches += 1
    return y


gn_silu.launches = 0


@functools.lru_cache(maxsize=512)
def nchw_backward_plan(b: int, c: int, hw: int, g: int, elem: int, vec: bool,
                       sms: int) -> NchwPlan:
    """The plan of one NCHW backward call of ``b`` rows, ``c`` channels,
    ``hw`` positions and ``g`` groups, elements of ``elem`` bytes, on a card
    of ``sms`` SMs.  ``vec``: the kernel moves 16-byte packs (else one
    element a load).  As :func:`nchw_plan`, with x and dy both staged: a run
    of more than ``_BWD_SLICE_UNITS`` goes to a cluster of q CTAs, the
    fewest that bring a slice to it (at most 8); fewer runs than SMs spread
    over more CTAs, none under ``_MIN_SLICE_UNITS``; a thread takes 2, 4 or
    8 units of a slice; small runs share a CTA up to ``_CTA_THREADS``
    threads while the card keeps a CTA on each SM.  A CTA keeps ``cap``
    units of each slice of x, and as many of dy, in shared memory
    (``smem``: x's slots, then dy's) up to ``_SMEM_MAX_B`` bytes; the
    ``reread`` units after them are read again in each of the kernel's three
    passes."""
    pack = 16 // elem if vec else 1
    unit = pack * elem
    units = c // g * hw // pack
    runs = b * g
    q = 1
    while q < _CLUSTER_B and -(-units // q) > _BWD_SLICE_UNITS:
        q *= 2
    while q < _CLUSTER_B and runs * q < sms and -(-units // (2 * q)) >= _MIN_SLICE_UNITS:
        q *= 2
    sl = -(-units // q)
    per_thread = 2 if sl <= 256 else 4 if sl <= 1024 else 8
    tpr = min(_THREADS_B, -(-sl // (32 * per_thread)) * 32)
    rpc = 1
    if q == 1:
        while 2 * rpc * tpr <= _CTA_THREADS and -(-runs // (2 * rpc)) >= sms:
            rpc *= 2
    cap = min(sl, _SMEM_MAX_B // (2 * rpc * unit))
    return NchwPlan(q, tpr * rpc, rpc, -(-runs // rpc) * q, 2 * rpc * cap * unit, sl, cap,
                    -(-cap // tpr), sl - cap)


def backward_plan(x: torch.Tensor, dy: torch.Tensor, num_groups: int) -> NchwPlan:
    """The plan :func:`gn_silu_backward` launches for CUDA ``x`` and ``dy``
    (its dx, fresh from the caching allocator, is 16-byte aligned; the
    launcher checks all three pointers against the plan)."""
    b, c, h, w = x.shape
    elem = x.element_size()
    vec = (h * w) % (16 // elem) == 0 and x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return nchw_backward_plan(b, c, h * w, num_groups, elem, vec, _sm_count(x.device))


_TICKETS = {}


def _tickets(device: torch.device, stream: int, groups: int) -> torch.Tensor:
    """The backward kernel's tickets for ``stream`` on ``device``: at least
    ``groups`` int32, zero between calls (the run that sums a group sets its
    ticket back).  Calls on one stream run in order, so they share them.
    Under CUDA graph capture a call gets tickets of its own, none kept: the
    graph holds their zero fill before the kernel, so every replay starts
    from zero whatever ran on the stream before it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(groups, dtype=torch.int32, device=device)
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    held = _TICKETS.get(key)
    if held is None or held.numel() < groups:
        held = _TICKETS[key] = torch.zeros(groups, dtype=torch.int32, device=device)
    return held


def gn_silu_backward(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """The gradient of :func:`gn_silu` for NCHW ``x`` (f32 or bf16) and ``dy``
    of ``x``'s type and shape: ``(dx, dweight, dbias)``, dx in ``x.dtype``,
    the others f32.  CUDA tensors run the kernel of ``csrc/gn_silu_bwd.cu``,
    planned by :func:`nchw_backward_plan`, one launch a call (the last run
    of each group sums its dweight and dbias); ``gn_silu_backward.launches``
    counts its launches."""
    if x.device.type == "cpu":
        return gn_silu_backward_reference(x, dy, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_backward runs on cuda or cpu, not {x.device}")
    _check(x, weight, bias, num_groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be a {x.dtype} {tuple(x.shape)} tensor on {x.device}, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    b, c, h, w = x.shape
    lib = _BWD_LIB.get()
    fn = lib.gn_silu_bwd_bf16 if x.dtype == torch.bfloat16 else lib.gn_silu_bwd_f32
    plan = backward_plan(x, dy, num_groups)
    dx = torch.empty_like(x)
    part = torch.empty(2 * b * c * plan.q, dtype=torch.float32, device=x.device)
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), dx.data_ptr(),
                part.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
                _tickets(x.device, stream, num_groups).data_ptr(), b, c, h * w, num_groups,
                eps, plan.q, plan.threads, plan.runs, plan.cap, plan.grid, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_backward kernel launch failed: CUDA error {rc} "
                           f"(plan {plan}, shape {tuple(x.shape)}, G={num_groups})")
    gn_silu_backward.launches += 1
    return dx, dweight, dbias


gn_silu_backward.launches = 0


class GroupNormSiLUFunction(torch.autograd.Function):
    """SiLU(GroupNorm(x)) with its gradient: ``forward`` (default
    :func:`gn_silu`) computes the output, ``backward`` (default
    :func:`gn_silu_backward`) the gradients of x, weight and bias from the
    saved x.  Each is the kernel on a CUDA tensor and the plain version on a
    CPU one; passing both plain versions routes both directions to them."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, forward=None, backward=None):
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        ctx.backward_fn = backward or gn_silu_backward
        return (forward or gn_silu)(x, weight, bias, num_groups, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = ctx.backward_fn(x, dy.contiguous(), weight, bias, ctx.num_groups,
                                             ctx.eps)
        return dx, dweight, dbias, None, None, None, None


def _divisor(h: int, w: int, count: int, offset: bool) -> float:
    """The statistics' element count per group: the offset grid carries one
    extra block per spatial axis whose out-of-range entries are zero."""
    return float(((h - 1) * (w - 1) if offset else h * w) * count)


def gn_silu_nhwc_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           group_of: torch.Tensor, num_groups: int, count: int,
                           offset: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch transcription of the packed engine's ``_GN`` + silu (+
    mask): f32 per-channel sums over positions, summed into groups by
    ``group_of`` (exact 0/1 products, no matmul and so no TF32), ``mean =
    s1 / n``, ``var = max(s2 / n - mean^2, 0)``, ``((x - mean) * rsqrt(var +
    eps)) * scale + bias``, ``y * sigmoid(y)``, the offset mask, one cast."""
    _, h, w, c4 = x.shape
    n = _divisor(h, w, count, offset)
    x32 = x.float()
    onehot = (group_of.long()[:, None] == torch.arange(num_groups, device=x.device)).float()
    s1 = (x32.sum(dim=(1, 2))[:, :, None] * onehot).sum(1)  # [B, G]
    s2 = ((x32 * x32).sum(dim=(1, 2))[:, :, None] * onehot).sum(1)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    mu = mean[:, group_of.long()][:, None, None, :]
    iv = torch.rsqrt(var + eps)[:, group_of.long()][:, None, None, :]
    y = (x32 - mu) * iv * scale.float() + bias.float()
    y = y * torch.sigmoid(y)
    if offset:
        y = y * torch.from_numpy(offset_mask(h, w, c4 // 4)).to(x.device)
    return y.to(x.dtype)


def _check_nhwc(x, scale, bias, group_of, num_groups, count, offset):
    if x.dim() != 4:
        raise ValueError(f"gn_silu_nhwc takes [B, H, W, C4] input, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gn_silu_nhwc takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_silu_nhwc needs a contiguous [B, H, W, C4] input")
    b, h, w, c4 = x.shape
    if x.numel() == 0 or not 1 <= num_groups <= min(c4, _MAX_GROUPS) or c4 > _MAX_CHANNELS:
        raise ValueError(f"bad shape {tuple(x.shape)} for {num_groups} groups (the kernel "
                         f"takes C4 <= {_MAX_CHANNELS}, G <= {_MAX_GROUPS})")
    if b > 65535 or h * w >= 2**31 or count < 1:
        raise ValueError(f"shape {tuple(x.shape)}, count {count} exceed the kernel's sizes")
    if offset and (c4 % 4 or h < 2 or w < 2):
        raise ValueError(f"an offset site needs C4 % 4 == 0 and H, W >= 2, got {tuple(x.shape)}")
    for name, p, dtype in (("scale", scale, torch.float32), ("bias", bias, torch.float32),
                           ("group_of", group_of, torch.int32)):
        if p.dtype != dtype or p.shape != (c4,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} [{c4}] tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, input on {x.device}")


class NhwcPlan(NamedTuple):
    """The grid of one :func:`gn_silu_nhwc` launch (``csrc/gn_silu.cu``,
    ``nhwc_gn_silu``): item ``b * k + i`` is positions ``[i * rows, (i + 1) *
    rows)`` of batch row ``b`` (the last range of a row may be shorter);
    block ``j`` of ``grid`` takes items ``j, j + grid, ...``; the first
    ``staged`` positions of each item are kept in shared memory between the
    two halves of the kernel, the rest is read twice."""

    k: int          # ranges per batch row
    rows: int       # positions per range
    staged: int     # positions of each item kept in shared memory
    grid: int       # blocks launched, all resident at once
    per_block: int  # items of the busiest block
    smem: int       # dynamic shared memory of a block, bytes
    work: int       # float32 workspace: [B * k, 2, C4] partial sums


def nhwc_fixed_bytes(c4: int, groups: int, pack: int) -> int:
    """Shared memory before the staging area (``nhwc_fixed_bytes`` in the
    source), in bytes rounded up to 128: the statistics' floats (``2 *
    pack`` row-lane sums a thread before the grid barrier, ``2 * C4``
    channel sums after it), ``2 * G`` group statistics and the group-major
    channel list of ``G + 1 + C4`` ints."""
    words = max(2 * c4, 2 * pack * _THREADS_N) + 3 * groups + 1 + c4
    return -(-4 * words // 128) * 128


@functools.lru_cache(maxsize=512)
def nhwc_plan(b: int, h: int, w: int, c4: int, groups: int, elem: int, vec: bool,
              sms: int) -> NhwcPlan:
    """The grid plan of one NHWC call on a card of ``sms`` SMs with one
    block resident on each: ``k`` ranges per row, as many as the card has
    blocks per row but none under ``_MIN_RANGE_BYTES``; each item's first
    positions kept, up to the block's shared memory; the grid no larger
    than ``sms``, so the cooperative launch fits.  ``vec``: the kernel
    moves 16-byte packs of channels (else one element at a time)."""
    hw, row_bytes = h * w, c4 * elem
    k = max(1, min(sms // b, -(-hw * row_bytes // _MIN_RANGE_BYTES), hw))
    rows = -(-hw // k)
    k = -(-hw // rows)  # no empty range
    items = b * k
    grid = min(items, sms)
    per_block = -(-items // grid)
    fixed = nhwc_fixed_bytes(c4, groups, 16 // elem if vec else 1)
    staged = min(rows, (_SMEM_MAX - fixed) // (per_block * row_bytes))
    return NhwcPlan(k, rows, staged, grid, per_block,
                    fixed + per_block * staged * row_bytes, items * 2 * c4)


def group_order(group_of: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The group-major channel list :func:`gn_silu_nhwc`'s kernel sums each
    group over: int32 ``[G + 1 + C4]``, the offset of each group's members,
    then the channels sorted by group (ascending within a group).  Channels
    whose group is out of range come last and belong to no group.  Built
    with tensor operations on ``group_of``'s device, without a host sync."""
    g = group_of.long()
    key = torch.where((g >= 0) & (g < num_groups), g, torch.full_like(g, num_groups))
    members = torch.sort(key, stable=True).indices
    counts = torch.zeros(num_groups + 1, dtype=torch.long, device=g.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    offsets = torch.cat([counts.new_zeros(1), counts[:num_groups].cumsum(0)])
    return torch.cat([offsets, members]).to(torch.int32)


_SMS = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def gn_silu_nhwc(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 group_of: torch.Tensor, num_groups: int, count: int,
                 offset: bool = False, eps: float = 1e-5,
                 order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SiLU(GroupNorm(x)) (times the offset mask at offset sites) for NHWC
    ``x`` ``[B, H, W, C4]`` (f32 or bf16) with f32 ``scale`` and ``bias``
    ``[C4]`` and an int32 channel -> group map ``group_of`` ``[C4]``;
    ``count`` is the number of channels per group at one position, so a
    group's statistics divide by ``H * W * count``, or ``(H-1)(W-1) * count``
    at offset sites.  ``order`` is ``group_order(group_of, num_groups)``,
    which a caller that keeps its map (``_GN``) builds once; without it the
    wrapper builds it.  CUDA tensors run the kernel, one launch;
    ``gn_silu_nhwc.launches`` counts its calls."""
    if x.device.type == "cpu":
        return gn_silu_nhwc_reference(x, scale, bias, group_of, num_groups, count, offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_nhwc runs on cuda or cpu, not {x.device}")
    _check_nhwc(x, scale, bias, group_of, num_groups, count, offset)
    b, h, w, c4 = x.shape
    if order is None:
        order = group_order(group_of, num_groups)
    elif (order.dtype != torch.int32 or order.shape != (num_groups + 1 + c4,)
          or not order.is_contiguous() or order.device != x.device):
        raise ValueError(f"order must be a contiguous int32 [{num_groups + 1 + c4}] tensor "
                         f"on {x.device}")
    lib = _LIB.get()
    fn = lib.gn_silu_nhwc_bf16 if x.dtype == torch.bfloat16 else lib.gn_silu_nhwc_f32
    y = torch.empty_like(x)
    pack = 16 // x.element_size()
    vec = c4 % pack == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    plan = nhwc_plan(b, h, w, c4, num_groups, x.element_size(), vec, _sm_count(x.device))
    work = torch.empty(plan.work, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), group_of.data_ptr(),
                order.data_ptr(), y.data_ptr(), work.data_ptr(), b, h, w, c4, num_groups,
                plan.k, plan.rows, plan.staged, plan.grid, plan.smem,
                _divisor(h, w, count, offset), int(offset), eps,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_nhwc kernel launch failed: CUDA error {rc} (plan {plan})")
    gn_silu_nhwc.launches += 1
    return y


gn_silu_nhwc.launches = 0
