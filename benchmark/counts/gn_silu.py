"""Least times of the GroupNorm+SiLU kernels at one site: each input read
once and each output written once at the peak bandwidth, against about ten
float32 operations per element forward and thirty backward, whichever is
longer.  Applied to the logical NCHW input of a site, so the same work is
counted however a program lays it out (packed, offset or NCHW).  Frozen
from ``chip_smoke.py``'s ``gn_bound`` and ``gn_bwd_bound``."""

from __future__ import annotations

from math import prod

from benchmark.counts.peaks import F32_OPS_PER_S, HBM_BYTES_PER_S


def forward_bound_s(shape, element_size: int) -> float:
    """One forward at a site of input ``shape`` (B, C, H, W): x read and y
    written once, the f32 affine read once."""
    n = prod(shape)
    n_bytes = 2 * n * element_size + 2 * shape[1] * 4
    return max(n_bytes / HBM_BYTES_PER_S, 10 * n / F32_OPS_PER_S)


def backward_bound_s(shape, element_size: int) -> float:
    """One backward at a site: x and dy read and dx written once, the [C]
    affine and its two gradients besides."""
    n = prod(shape)
    n_bytes = 3 * n * element_size + 4 * shape[1] * 4
    return max(n_bytes / HBM_BYTES_PER_S, 30 * n / F32_OPS_PER_S)
