"""Fused GroupNorm + SiLU: the CUDA kernel ``csrc/gn_silu.cu`` and its plain
PyTorch version.

Counterpart of ``sddm_tpu/experimental/pallas_groupnorm_swish.py``
(``group_norm_swish``) and of the flax ``GroupNorm`` -> swish prologue of
``sddm_tpu/models/blocks.py::Block``.  Layout is NCHW: a (batch row, group)
is one contiguous run of ``C / G * H * W`` values.

The kernel is compiled at first use with ``nvcc`` into ``_build/`` inside
this package (git-ignored) and loaded with ``ctypes``; a CPU tensor takes
:func:`gn_silu_reference` instead, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CSRC, CudaLibrary

SOURCE = CSRC / "gn_silu.cu"
_LIB = CudaLibrary(SOURCE, {
    name: [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    for name in ("gn_silu_f32", "gn_silu_bf16")
})


def build() -> dict:
    """Compile ``csrc/gn_silu.cu`` (see :func:`cuda_build.build`)."""
    return _LIB.build()


def gn_silu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch GroupNorm + SiLU with flax's arithmetic: f32 statistics,
    ``var = max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, ``y * sigmoid(y)``, cast back to ``x.dtype``."""
    b, c = x.shape[:2]
    xg = x.float().reshape(b, num_groups, c // num_groups, -1)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    shape = (1, num_groups, c // num_groups, 1)
    mul = torch.rsqrt(var + eps) * weight.float().reshape(shape)
    y = (xg - mean) * mul + bias.float().reshape(shape)
    y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


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
    if h * w >= 2**31 or b * num_groups >= 2**31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's int32 sizes")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, input on {x.device}")


def gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)) for NCHW ``x`` (f32 or bf16) with f32 ``weight``
    and ``bias`` of shape ``[C]``.  CUDA tensors run the kernel;
    ``gn_silu.launches`` counts its launches."""
    if x.device.type == "cpu":
        return gn_silu_reference(x, weight, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu runs on cuda or cpu, not {x.device}")
    _check(x, weight, bias, num_groups)
    lib = _LIB.get()
    fn = lib.gn_silu_bf16 if x.dtype == torch.bfloat16 else lib.gn_silu_f32
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                b, c, h * w, num_groups, eps,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu kernel launch failed: CUDA error {rc}")
    gn_silu.launches += 1
    return y


gn_silu.launches = 0
