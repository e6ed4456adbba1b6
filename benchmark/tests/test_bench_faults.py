"""A run of each kind of cell with its timed path broken underneath sees
``correct`` come out false, and the same run unbroken sees it true: the
harness's run without its look for a chip, on the CPU, at a size a test
run holds (the cell's widths cut, float32; the limits are the cell's own)."""

from __future__ import annotations

import copy

import pytest

from benchmark import harness

SEED = 2**31 + 77


def tiny(name):
    cell = harness.cell_of(harness.load_spec(), name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["dtype"] = "float32"
    if tr["kind"] == "enhance":
        cfg["network"]["args"].update(inner_channel=8, norm_groups=4)
        tr.update(batch_rows=4, fill_rows=4)
        tr["sampler"]["steps"] = 2
        tr["lengths"].update(median_s=1.5, min_s=0.5, max_s=3.0, grid=16)
        tr["check"]["calls"] = 2
    elif tr["kind"] == "vocode":
        cfg["network"]["args"].update(residual_layers=4, dilation_cycle_length=2)
        tr.update(batch=2, frames=4, pool=4)
        tr["check"]["calls"] = 2
    else:
        cfg["network"]["args"].update(inner_channel=8, norm_groups=4)
        tr.update(batch=4, pool_rows=16)
    cell.config, cell.traffic = cfg, tr
    return cell


CASES = [("enhance-flagship-r256", ()), ("enhance-flagship-r256", ("step_unchanged",)),
         ("enhance-flagship-r256", ("answer_altered",)),
         ("vocode-diffwave-b16", ()), ("vocode-diffwave-b16", ("step_unchanged",)),
         ("vocode-diffwave-b16", ("answer_altered",)),
         ("train-flagship-b256", ()), ("train-flagship-b256", ("step_unchanged",)),
         ("train-flagship-b256", ("half_batch",))]


@pytest.mark.parametrize("workload,faults", CASES)
def test_correct_only_without_a_fault(workload, faults):
    result = harness.run(tiny(workload), SEED, 0.5, False, "cpu", faults=faults)
    assert result["correct"] is (not faults), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(c["limit"] is not None for c in result["checks"].values())
