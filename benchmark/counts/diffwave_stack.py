"""Least time of one call of the DiffWave residual-stack kernel: its inputs
(x0 [B, T, C], the per-layer condition [L, B, T, 2C], the embedding [L, B,
C], the stacked weights [L, 3, C, 2C] and [L, C, 2C], the bias [L, 1, 2C])
read once and the skip sum [B, T, C] written once at the peak bandwidth,
against 2 B T L (3 C 2C + C 2C) operations at the peak of the type,
whichever is longer.  Frozen from ``chip_smoke.py``'s ``stack_bound``."""

from __future__ import annotations

from benchmark.counts.peaks import BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S


def call_bound_s(B: int, T: int, C: int, L: int, element_size: int) -> float:
    elements = (B * T * C + L * B * T * 2 * C + L * B * C + L * 3 * C * 2 * C
                + L * C * 2 * C + L * 2 * C) + B * T * C
    n_bytes = elements * element_size
    ops = 2 * B * T * L * (3 * C * 2 * C + C * 2 * C)
    peak = BF16_OPS_PER_S if element_size == 2 else F32_OPS_PER_S
    return max(n_bytes / HBM_BYTES_PER_S, ops / peak)
