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

Each layout has a backward too, none with a TPU counterpart (JAX
differentiates flax's GroupNorm -> swish and the packed engine's jnp ``_GN``
through XLA): :func:`gn_silu_backward`, the kernel of ``csrc/gn_silu_bwd.cu``,
with its plain version :func:`gn_silu_backward_reference`, and
:func:`gn_silu_nhwc_backward`, the kernels of ``csrc/gn_silu_nhwc_bwd.cu``
(planned by :func:`nhwc_backward_plan`), with
:func:`gn_silu_nhwc_backward_reference`.  :class:`GroupNormSiLUFunction` and
:class:`GroupNormSiLUNhwcFunction` join the two directions for autograd.

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
_NHWC_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
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
NHWC_BACKWARD_SOURCE = CSRC / "gn_silu_nhwc_bwd.cu"
_NHWC_BWD_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_NHWC_BWD_LIB = CudaLibrary(NHWC_BACKWARD_SOURCE, {
    "gn_silu_nhwc_bwd_f32": _NHWC_BWD_ARGS, "gn_silu_nhwc_bwd_bf16": _NHWC_BWD_ARGS,
    "gn_silu_nhwc_bwd_blocks_per_sm": [ctypes.c_int] * 3 + [ctypes.c_void_p],
})
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
# The NHWC backward's constants (csrc/gn_silu_nhwc_bwd.cu: kThreadsB, kSmemMaxB,
# kPackBytesB): 512 threads a block, one block an SM with 227 KB of shared
# memory, 8 bytes of x (and of dy) a thread at a position.
_THREADS_BN, _SMEM_MAX_BN, _PACK_BYTES_BN = 512, 232448, 8


def build() -> dict:
    """Compile ``csrc/gn_silu.cu``, both layouts (see :func:`cuda_build.build`)."""
    return _LIB.build()


def build_backward() -> dict:
    """Compile ``csrc/gn_silu_bwd.cu``, the NCHW backward."""
    return _BWD_LIB.build()


def build_nhwc_backward() -> dict:
    """Compile ``csrc/gn_silu_nhwc_bwd.cu``, the NHWC backward."""
    return _NHWC_BWD_LIB.build()


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
    """The backward kernels' tickets for ``stream`` on ``device``: at least
    ``groups`` int32, zero between calls (the NCHW kernel's run that sums a
    group sets its ticket back, the NHWC kernel's block 0 every row's).
    Calls on one stream run in order, so they share them.
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


def _nhwc_moments(x: torch.Tensor, group_of: torch.Tensor, num_groups: int, n: float):
    """(x in the compute dtype, each group's mean and ``s2 / n - mean^2``,
    ``[B, G]``): per-channel sums over positions, summed into groups by
    ``group_of`` (exact 0/1 products, no matmul and so no TF32)."""
    xc = x.to(_compute_dtype(x))
    onehot = (group_of.long()[:, None] == torch.arange(num_groups, device=x.device)).to(xc.dtype)
    s1 = (xc.sum(dim=(1, 2))[:, :, None] * onehot).sum(1)  # [B, G]
    s2 = ((xc * xc).sum(dim=(1, 2))[:, :, None] * onehot).sum(1)
    mean = s1 / n
    return xc, mean, s2 / n - mean * mean


def gn_silu_nhwc_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           group_of: torch.Tensor, num_groups: int, count: int,
                           offset: bool = False, eps: float = 1e-5,
                           stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch transcription of the packed engine's ``_GN`` + silu (+
    mask): f32 per-channel sums over positions, summed into groups by
    ``group_of``, ``mean = s1 / n``, ``var = max(s2 / n - mean^2, 0)``,
    ``((x - mean) * rsqrt(var + eps)) * scale + bias``, ``y * sigmoid(y)``,
    the offset mask, one cast (a float64 input is computed in float64).
    ``stats``, where given (``[B, G, 2]``), receives each group's mean and
    unclamped ``s2 / n - mean^2``, as the kernel writes them for its
    backward."""
    _, h, w, c4 = x.shape
    xc, mean, v = _nhwc_moments(x, group_of, num_groups, _divisor(h, w, count, offset))
    if stats is not None:
        stats.copy_(torch.stack([mean, v], dim=-1))
    var = torch.clamp_min(v, 0.0)
    mu = mean[:, group_of.long()][:, None, None, :]
    iv = torch.rsqrt(var + eps)[:, group_of.long()][:, None, None, :]
    y = (xc - mu) * iv * scale.to(xc.dtype) + bias.to(xc.dtype)
    y = y * torch.sigmoid(y)
    if offset:
        y = y * torch.from_numpy(offset_mask(h, w, c4 // 4)).to(x.device, xc.dtype)
    return y.to(x.dtype)


def gn_silu_nhwc_backward_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                    bias: torch.Tensor, group_of: torch.Tensor, num_groups: int,
                                    count: int, offset: bool = False, eps: float = 1e-5):
    """Plain PyTorch gradient of :func:`gn_silu_nhwc_reference`, in closed
    form: ``(dx, dscale, dbias)``, dx in ``x.dtype``, the others f32 (f64
    for a float64 input), per packed channel.  With the forward's ``mean``
    and ``v = s2 / n - mean^2`` of each (row, group), ``r = rsqrt(max(v, 0) +
    eps)``, ``xhat = (x - mean) r``, ``y = xhat scale + bias``, ``s =
    sigmoid(y)`` and the offset mask ``m``: ``dz = (dy m) s (1 + y (1 -
    s))``, ``dbias = sum dz``, ``dscale = sum dz xhat`` (over rows and
    positions), ``dx = r (dz scale - A / n - xhat B / n)`` with ``A`` and
    ``B`` each (row, group)'s sums of ``dz scale`` and ``dz scale xhat``
    over its channels and positions.  Where ``v < 0`` the last term is
    dropped: ``clamp_min`` passes no gradient there, as torch autograd of the
    forward gives."""
    b, h, w, c4 = x.shape
    n = _divisor(h, w, count, offset)
    xc, mean, v = _nhwc_moments(x, group_of, num_groups, n)
    ct = xc.dtype
    g = group_of.long()
    r = torch.rsqrt(torch.clamp_min(v, 0.0) + eps)
    xhat = (xc - mean[:, g][:, None, None, :]) * r[:, g][:, None, None, :]
    y = xhat * scale.to(ct) + bias.to(ct)
    s = torch.sigmoid(y)
    g_y = dy.to(ct)
    if offset:
        g_y = g_y * torch.from_numpy(offset_mask(h, w, c4 // 4)).to(x.device, ct)
    dz = g_y * (s * (1 + y * (1 - s)))
    sum_dz, sum_dzx = dz.sum(dim=(1, 2)), (dz * xhat).sum(dim=(1, 2))  # [B, C4]
    onehot = (g[:, None] == torch.arange(num_groups, device=x.device)).to(ct)
    a_g = ((sum_dz * scale.to(ct))[:, :, None] * onehot).sum(1) / n  # [B, G]
    b_g = torch.where(v < 0, 0.0, ((sum_dzx * scale.to(ct))[:, :, None] * onehot).sum(1) / n)
    dx = r[:, g][:, None, None, :] * (dz * scale.to(ct) - a_g[:, g][:, None, None, :]
                                      - xhat * b_g[:, g][:, None, None, :])
    return dx.to(x.dtype), sum_dzx.sum(0), sum_dz.sum(0)


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
                 order: Optional[torch.Tensor] = None,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SiLU(GroupNorm(x)) (times the offset mask at offset sites) for NHWC
    ``x`` ``[B, H, W, C4]`` (f32 or bf16) with f32 ``scale`` and ``bias``
    ``[C4]`` and an int32 channel -> group map ``group_of`` ``[C4]``;
    ``count`` is the number of channels per group at one position, so a
    group's statistics divide by ``H * W * count``, or ``(H-1)(W-1) * count``
    at offset sites.  ``order`` is ``group_order(group_of, num_groups)``,
    which a caller that keeps its map (``_GN``) builds once; without it the
    wrapper builds it.  ``stats``, where given, is a float32 ``[B, G, 2]``
    tensor that receives each group's mean and unclamped ``s2 / n - mean^2``
    for :func:`gn_silu_nhwc_backward`; serving passes none.  CUDA tensors run
    the kernel, one launch; ``gn_silu_nhwc.launches`` counts its calls."""
    if x.device.type == "cpu":
        return gn_silu_nhwc_reference(x, scale, bias, group_of, num_groups, count, offset, eps,
                                      stats)
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
    if stats is not None:
        _check_stats(stats, x, num_groups)
    lib = _LIB.get()
    fn = lib.gn_silu_nhwc_bf16 if x.dtype == torch.bfloat16 else lib.gn_silu_nhwc_f32
    y = torch.empty_like(x)
    pack = 16 // x.element_size()
    vec = c4 % pack == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    plan = nhwc_plan(b, h, w, c4, num_groups, x.element_size(), vec, _sm_count(x.device))
    work = torch.empty(plan.work, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), group_of.data_ptr(),
                order.data_ptr(), y.data_ptr(), work.data_ptr(),
                0 if stats is None else stats.data_ptr(), b, h, w, c4, num_groups,
                plan.k, plan.rows, plan.staged, plan.grid, plan.smem,
                _divisor(h, w, count, offset), int(offset), eps,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_nhwc kernel launch failed: CUDA error {rc} (plan {plan})")
    gn_silu_nhwc.launches += 1
    return y


gn_silu_nhwc.launches = 0


def _check_stats(stats: torch.Tensor, x: torch.Tensor, num_groups: int) -> None:
    want = (x.shape[0], num_groups, 2)
    if (stats.dtype != torch.float32 or tuple(stats.shape) != want
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"stats must be a contiguous float32 {list(want)} tensor on {x.device}, "
                         f"got {stats.dtype} {list(stats.shape)} on {stats.device}")


class NhwcBackwardPlan(NamedTuple):
    """The launch of one :func:`gn_silu_nhwc_backward` call
    (``csrc/gn_silu_nhwc_bwd.cu``, ``nhwc_bwd_fused``): item ``b * k + i`` is
    positions ``[i * rows, (i + 1) * rows)`` of batch row ``b`` (the last
    range of a row may be shorter), all channels; block ``j`` of ``grid``
    takes items ``j, j + grid, ...``, so the card takes the rows in
    ``waves``.  A block keeps the first ``staged`` positions of ``buffers``
    items' x and dy in shared memory and reads the rest again.  With two, a
    block sums its next item before it waits for this one's row, so a row
    may span two waves, and copies the item after next into a slot chunk by
    chunk as it writes dx from it; with one, a wave is whole rows (the grid
    a multiple of ``k``)."""

    k: int        # ranges per batch row
    rows: int     # positions per range
    staged: int   # positions of a range kept in shared memory
    buffers: int  # items a block keeps at once: 2 or 1
    items: int    # B * k
    grid: int     # blocks launched, all resident at once
    waves: int    # items of the busiest block
    smem: int     # dynamic shared memory of a block, bytes
    work: int     # float32 workspace: [B, 2, C4 + G] row sums, [B * k, 2, C4 + G] partials


def nhwc_backward_fixed_bytes(c4: int, groups: int, pack: int) -> int:
    """Shared memory before the staging area (``bwd_fixed_bytes`` in the
    source), in bytes rounded up to 128: 128 bytes of mbarriers and an int,
    ``2 * pack * 512`` row-lane sums, ``[2, C4]`` channel sums, ``[C4]``
    scale, ``[6, G]`` group sums and coefficients, and the group-major
    channel list of ``G + 1 + C4`` ints."""
    words = 2 * pack * _THREADS_BN + 3 * c4 + 6 * groups + groups + 1 + c4
    return -(-(128 + 4 * words) // 128) * 128


def nhwc_backward_item_bytes(staged: int, c4: int, groups: int, elem: int) -> int:
    """One staged item (``bwd_item_bytes`` in the source): x and dy of
    ``staged`` positions and the row's ``[G, 2]`` statistics, in bytes
    rounded up to 16."""
    return -(-(2 * staged * c4 * elem + 8 * groups) // 16) * 16


@functools.lru_cache(maxsize=512)
def nhwc_backward_plan(b: int, h: int, w: int, c4: int, groups: int, elem: int, vec: bool,
                       sms: int, per_sm: int) -> NhwcBackwardPlan:
    """The plan of one NHWC backward call on a card of ``sms`` SMs that
    holds ``per_sm`` blocks an SM at once (``nhwc_backward_blocks_per_sm``).
    Ranges hold as many positions as a block keeps (x and dy, elements of
    ``elem`` bytes, in what shared memory leaves), more of them where the
    card would otherwise idle, none under ``_MIN_RANGE_BYTES`` of x.  A block
    keeps two items at once where 16-byte spans (``vec``) let bulk copies
    stage them, half the shared memory still holds a whole range, and there
    is more than one wave; the grid is then every resident block.
    Else one item, and a wave of as many whole rows as the resident blocks
    hold, which it takes all of: a block waits for its row right after its
    sums, so no row may wait for the next wave.  With two items a row may
    have up to twice as many ranges as there are blocks: a block takes its
    next item's ticket before it waits for this one's row."""
    hw, row_bytes = h * w, c4 * elem
    blocks = sms * per_sm
    room = _SMEM_MAX_BN - nhwc_backward_fixed_bytes(c4, groups,
                                                    _PACK_BYTES_BN // elem if vec else 1)
    spread = min(blocks // b, -(-hw * row_bytes // _MIN_RANGE_BYTES), hw)

    def layout(buffers, whole_rows):
        per_item = room // buffers // 16 * 16
        cap = max(0, (per_item - 8 * groups) // (2 * row_bytes))  # positions kept
        most = blocks if whole_rows else 2 * blocks  # ranges a row the waits allow
        fewest = -(-hw // cap) if cap else most
        k = max(1, min(most, max(fewest, spread)))
        slots = max(1, min(b, blocks // k))
        if whole_rows and slots < b:
            k = blocks // slots  # the wave's rows take every block
        rows = -(-hw // k)
        k = -(-hw // rows)  # no empty range
        return k, rows, min(rows, cap), slots * k if whole_rows else min(b * k, blocks)

    buffers = 2
    k, rows, staged, grid = layout(2, False)
    if not (vec and staged == rows and b * k > grid):
        buffers = 1
        k, rows, staged, grid = layout(1, True)
    items = b * k
    work = b * 2 * (c4 + groups) + (items * 2 * (c4 + groups) if k > 1 else 0)
    return NhwcBackwardPlan(k, rows, staged, buffers, items, grid, -(-items // grid),
                            _SMEM_MAX_BN - room
                            + buffers * nhwc_backward_item_bytes(staged, c4, groups, elem), work)


_BWD_PER_SM = {}


def nhwc_backward_blocks_per_sm(device: torch.device, elem: int, vec: bool) -> int:
    """The backward kernel's blocks that one SM of ``device`` holds at once
    with the most shared memory a plan gives a block
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), once per device and
    instantiation."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, elem, bool(vec))
    if key not in _BWD_PER_SM:
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = _NHWC_BWD_LIB.get().gn_silu_nhwc_bwd_blocks_per_sm(elem, int(vec), _SMEM_MAX_BN,
                                                                    ctypes.addressof(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"the NHWC backward kernel fits {n.value} blocks an SM "
                               f"(CUDA error {rc})")
        _BWD_PER_SM[key] = n.value
    return _BWD_PER_SM[key]


def nhwc_backward_plan_of(x: torch.Tensor, num_groups: int,
                          dy: Optional[torch.Tensor] = None) -> NhwcBackwardPlan:
    """The plan :func:`gn_silu_nhwc_backward` launches for CUDA ``x`` (and
    ``dy``: its dx, fresh from the caching allocator, is 16-byte aligned; the
    launcher checks all three pointers against the plan)."""
    c4, elem = x.shape[-1], x.element_size()
    vec = c4 % (16 // elem) == 0 and all(t.data_ptr() % 16 == 0 for t in (x, dy)
                                         if t is not None)
    return nhwc_backward_plan(*x.shape, num_groups, elem, vec, _sm_count(x.device),
                              nhwc_backward_blocks_per_sm(x.device, elem, vec))


def gn_silu_nhwc_backward(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, group_of: torch.Tensor, num_groups: int,
                          count: int, offset: bool = False, eps: float = 1e-5,
                          order: Optional[torch.Tensor] = None,
                          stats: Optional[torch.Tensor] = None):
    """The gradient of :func:`gn_silu_nhwc` for NHWC ``x`` (f32 or bf16) and
    ``dy`` of ``x``'s type and shape: ``(dx, dscale, dbias)``, dx in
    ``x.dtype``, the others f32 ``[C4]`` (views of one buffer).  CUDA tensors
    run the kernel of ``csrc/gn_silu_nhwc_bwd.cu``, one cooperative launch
    planned by :func:`nhwc_backward_plan`, and need ``stats``, the ``[B, G,
    2]`` statistics :func:`gn_silu_nhwc` wrote for the same ``x``; ``order``
    as for the forward.  ``gn_silu_nhwc_backward.launches`` counts its
    launches."""
    if x.device.type == "cpu":
        return gn_silu_nhwc_backward_reference(x, dy, scale, bias, group_of, num_groups, count,
                                               offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu_nhwc_backward runs on cuda or cpu, not {x.device}")
    _check_nhwc(x, scale, bias, group_of, num_groups, count, offset)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be a {x.dtype} {tuple(x.shape)} tensor on {x.device}, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if stats is None:
        raise ValueError("gn_silu_nhwc_backward on a card needs the forward's statistics "
                         "(gn_silu_nhwc(..., stats=...))")
    _check_stats(stats, x, num_groups)
    b, h, w, c4 = x.shape
    if order is None:
        order = group_order(group_of, num_groups)
    dy = dy.contiguous()
    lib = _NHWC_BWD_LIB.get()
    fn = lib.gn_silu_nhwc_bwd_bf16 if x.dtype == torch.bfloat16 else lib.gn_silu_nhwc_bwd_f32
    plan = nhwc_backward_plan_of(x, num_groups, dy)
    dx = torch.empty_like(x)
    # one allocation for the workspace (first, 16-byte aligned), dbias and dscale
    buf = torch.empty(plan.work + 2 * c4, dtype=torch.float32, device=x.device)
    dbias, dscale = buf[plan.work:plan.work + c4], buf[plan.work + c4:]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                group_of.data_ptr(), order.data_ptr(), stats.data_ptr(), dx.data_ptr(),
                buf.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                _tickets(x.device, stream, b).data_ptr(), b, h, w, c4, num_groups,
                plan.k, plan.rows, plan.staged, plan.buffers, plan.grid, plan.smem,
                _divisor(h, w, count, offset), int(offset), eps, stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_nhwc_backward kernel launch failed: CUDA error {rc} "
                           f"(plan {plan}, shape {tuple(x.shape)}, G={num_groups})")
    gn_silu_nhwc_backward.launches += 1
    return dx, dscale, dbias


gn_silu_nhwc_backward.launches = 0


class GroupNormSiLUNhwcFunction(torch.autograd.Function):
    """:func:`gn_silu_nhwc` with its gradient: ``forward`` (default
    :func:`gn_silu_nhwc`) computes the output and the statistics,
    ``backward`` (default :func:`gn_silu_nhwc_backward`) the gradients of x,
    scale and bias from the saved x and statistics.  Each is the kernel on a
    CUDA tensor and the plain version on a CPU one; passing both plain
    versions routes both directions to them."""

    @staticmethod
    def forward(ctx, x, scale, bias, group_of, num_groups, count, offset, eps, order=None,
                forward=None, backward=None):
        stats = torch.empty((x.shape[0], num_groups, 2), dtype=_compute_dtype(x),
                            device=x.device)
        y = (forward or gn_silu_nhwc)(x, scale, bias, group_of, num_groups, count, offset, eps,
                                      order=order, stats=stats)
        ctx.save_for_backward(x, scale, bias, group_of, order, stats)
        ctx.args = (num_groups, count, offset, eps)
        ctx.backward_fn = backward or gn_silu_nhwc_backward
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, scale, bias, group_of, order, stats = ctx.saved_tensors
        dx, dscale, dbias = ctx.backward_fn(x, dy.contiguous(), scale, bias, group_of, *ctx.args,
                                            order=order, stats=stats)
        return dx, dscale, dbias, None, None, None, None, None, None, None, None
