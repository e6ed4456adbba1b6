"""The mesh cell's run over two gloo ranks on the CPU, at a size a test
holds: correct as it is, not correct with the exchange between the ranks
left out or with the sampler's last step returning its state."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT


@pytest.mark.parametrize("faults,correct", [((), True), (("exchange_left_out",), False),
                                            (("step_unchanged",), False)])
def test_mesh_run_over_two_ranks(faults, correct):
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", str(ROOT / "benchmark" / "tests" / "mesh_rank.py"),
                          *faults], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is correct, result
    assert result["attempted"] > 0
