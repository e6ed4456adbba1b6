"""On the card, at each cell's own size: the program's outputs hold to the
cell's limits and the control (the reference in fp8 in the program's place)
breaks at least one, as does the training cell's step on half its batch.
Run on the chip:

    python -m pytest benchmark/tests -m chip
"""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.control import reading

SEED = 2**31 + 4242
CELLS = ["enhance-flagship-r64", "enhance-flagship-r256", "vocode-diffwave-b16",
         "train-flagship-b256"]


def within(numbers: dict, limits: dict) -> bool:
    """Every number the cell compares within its limit."""
    return all(numbers[k] <= v["limit"] for k, v in limits.items())


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_program_holds_and_control_breaks(card, workload):
    cell = harness.cell_of(harness.load_spec(), workload)
    r = reading(cell, SEED, 3.0, card, control=True)
    assert r["failed"] == 0 and within(r["checks"], cell.limits), r
    assert not within(r["control"], cell.limits), r


@pytest.mark.chip
def test_half_batch_step_breaks_the_training_cell(card):
    """The train step on half of its rows, the mean taken over those, at
    the cell's own 256 rows."""
    cell = harness.cell_of(harness.load_spec(), "train-flagship-b256")
    r = reading(cell, SEED, 3.0, card, control=False, faults=("half_batch",))
    assert not within(r["checks"], cell.limits), r
