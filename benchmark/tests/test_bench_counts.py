"""The frozen byte and operation counts against ``chip_smoke.py``'s
formulas, from which they were frozen, at one shape each."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark.counts import diffwave_stack, gn_silu, peaks
from benchmark.harness import ROOT


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_peaks_are_chip_smokes(chip_smoke):
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.F32_OPS_PER_S == chip_smoke.F32_OPS_PER_S
    assert peaks.BF16_OPS_PER_S == chip_smoke.BF16_OPS_PER_S


def test_forward_bound_is_gn_bound(chip_smoke):
    x = torch.empty(16, 64, 256, 128, dtype=torch.bfloat16, device="meta")
    ms, _, _ = chip_smoke.gn_bound(x, 2 * 64 * 4)
    assert gn_silu.forward_bound_s(tuple(x.shape), 2) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_backward_bound_is_gn_bwd_bound(chip_smoke):
    x = torch.empty(16, 64, 256, 128, dtype=torch.bfloat16, device="meta")
    ms, _, _ = chip_smoke.gn_bwd_bound(x)
    assert gn_silu.backward_bound_s(tuple(x.shape), 2) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_stack_bound_is_chip_smokes(chip_smoke):
    B, T, C, L = 8, 16384, 64, 30
    bf = torch.bfloat16
    args = [torch.empty(B, T, C, dtype=bf, device="meta"),
            torch.empty(L, B, T, 2 * C, dtype=bf, device="meta"),
            torch.empty(L, B, C, dtype=bf, device="meta"),
            torch.empty(L, 3, C, 2 * C, dtype=bf, device="meta"),
            torch.empty(L, C, 2 * C, dtype=bf, device="meta"),
            torch.empty(L, 1, 2 * C, dtype=bf, device="meta")]
    ms, _, _, _ = chip_smoke.stack_bound(args)
    assert diffwave_stack.call_bound_s(B, T, C, L, 2) * 1e3 == pytest.approx(ms, rel=1e-12)
