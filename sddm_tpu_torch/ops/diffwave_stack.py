"""The gated residual stack of DiffWave: the CUDA kernel
``csrc/diffwave_stack.cu`` and its plain PyTorch version.

Counterpart of ``sddm_tpu/ops/pallas/diffwave_stack.py`` (``diffwave_stack``
and ``diffwave_stack_reference``), with its layout and arguments:

    x0:    [B, T, C]     stem output (post-relu)
    cond:  [L, B, T, 2C] per-layer conditioner projection + dilated-conv bias
    emb_d: [L, B, C]     per-layer Dense(diffusion embedding) outputs
    wconv: [L, 3, C, 2C] dilated conv kernels
    wrs:   [L, C, 2C]    res and skip kernels side by side
    brs:   [L, 1, 2C]    res and skip biases
    cycle: the dilation of layer l is 2 ** (l % cycle)

and returns the skip sum ``[B, T, C]`` in ``x0``'s dtype.  A CPU tensor takes
:func:`diffwave_stack_reference`; a CUDA tensor launches the kernel (one
launch per layer) or raises.  ``diffwave_stack.launches`` counts stack calls
that ran the kernel and ``diffwave_stack.layer_launches`` their layer
launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .cuda_build import CSRC, CudaLibrary

SOURCE = CSRC / "diffwave_stack.cu"
CHANNELS = (32, 64)  # the residual channel counts the kernel is built for
_RSQRT2 = 1.0 / math.sqrt(2.0)
_LIB = CudaLibrary(SOURCE, {
    name: [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for name in ("diffwave_stack_f32", "diffwave_stack_bf16")
})


def build() -> dict:
    """Compile ``csrc/diffwave_stack.cu`` (see :func:`cuda_build.build`)."""
    return _LIB.build()


def diffwave_stack_reference(x0, cond, emb_d, wconv, wrs, brs, *, cycle: int) -> torch.Tensor:
    """Plain PyTorch layer loop with the rounding points of the JAX
    ``diffwave_stack_reference``: ``x + emb`` in ``x0``'s dtype, the tap
    products and the gate in float32, the gate rounded to ``x0``'s dtype
    before the res/skip product, ``x`` rounded once per layer, and the skip
    sum added in ``x0``'s dtype."""
    L = wconv.shape[0]
    T, C = x0.shape[1:]
    emb_d = emb_d.to(x0.dtype)
    x, skip = x0, torch.zeros_like(x0)
    for l in range(L):
        d = 1 << (l % cycle)
        xd = F.pad(x + emb_d[l][:, None, :], (0, 0, d, d))  # SAME zero padding on T
        y = torch.zeros(cond.shape[1:], dtype=torch.float32, device=x0.device)
        for k in range(3):
            y = y + xd[:, k * d:k * d + T].float() @ wconv[l, k].float()
        y = y + cond[l].float()
        g = torch.sigmoid(y[..., :C]) * torch.tanh(y[..., C:])
        rs = g.to(x.dtype).float() @ wrs[l].float() + brs[l].float()
        x = ((x.float() + rs[..., :C]) * _RSQRT2).to(x.dtype)
        skip = skip + rs[..., C:].to(skip.dtype)
    return skip


def _check(x0, cond, emb_d, wconv, wrs, brs, cycle):
    if x0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"diffwave_stack takes float32 or bfloat16, got {x0.dtype}")
    if x0.dim() != 3:
        raise ValueError(f"x0 must be [B, T, C], got {tuple(x0.shape)}")
    B, T, C = x0.shape
    L = wconv.shape[0]
    if C not in CHANNELS:
        raise ValueError(f"the kernel takes C in {CHANNELS} channels, got {C}")
    if B == 0 or T == 0 or L == 0 or B > 65535 or L * B * T * 2 * C >= 2**62:
        raise ValueError(f"bad stack shape B={B}, T={T}, L={L}")
    # the persistent kernel's TMA coordinates are signed 32-bit (t - d must
    # fit) and cond's outer stride, B T 2C 2 bytes, must stay below 2**40
    if T >= 2**30 or B * T >= 2**32:
        raise ValueError(f"the kernel takes T < 2**30 and B*T < 2**32, got B={B}, T={T}")
    if not 1 <= cycle <= 30:
        raise ValueError(f"cycle must be in [1, 30], got {cycle}")
    want = {"x0": (B, T, C), "cond": (L, B, T, 2 * C), "emb_d": (L, B, C),
            "wconv": (L, 3, C, 2 * C), "wrs": (L, C, 2 * C), "brs": (L, 1, 2 * C)}
    for (name, shape), t in zip(want.items(), (x0, cond, emb_d, wconv, wrs, brs)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
        if t.dtype != x0.dtype or t.device != x0.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x0 {x0.dtype} on {x0.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def diffwave_stack(x0, cond, emb_d, wconv, wrs, brs, *, cycle: int) -> torch.Tensor:
    """Run the gated residual stack and return its skip sum (see the module
    docstring).  ``emb_d`` is cast to ``x0``'s dtype, as the JAX kernel casts
    it; every other input must already be of that dtype."""
    if x0.device.type == "cpu":
        return diffwave_stack_reference(x0, cond, emb_d, wconv, wrs, brs, cycle=cycle)
    if x0.device.type != "cuda":
        raise ValueError(f"diffwave_stack runs on cuda or cpu, not {x0.device}")
    emb_d = emb_d.to(x0.dtype).contiguous()
    _check(x0, cond, emb_d, wconv, wrs, brs, cycle)
    lib = _LIB.get()
    fn = lib.diffwave_stack_bf16 if x0.dtype == torch.bfloat16 else lib.diffwave_stack_f32
    B, T, C = x0.shape
    L = wconv.shape[0]
    xa, xb, skip = (torch.empty_like(x0) for _ in range(3))
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), xa.data_ptr(), xb.data_ptr(), skip.data_ptr(),
                cond.data_ptr(), emb_d.data_ptr(), wconv.data_ptr(), wrs.data_ptr(),
                brs.data_ptr(), B, T, L, cycle, C,
                torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"diffwave_stack kernel launch failed: CUDA error {rc}")
    diffwave_stack.launches += 1
    diffwave_stack.layer_launches += L
    return skip


diffwave_stack.launches = 0
diffwave_stack.layer_launches = 0
