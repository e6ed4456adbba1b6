"""Without the cards a cell asks for, a run prints no result and fails; it
never falls back to the CPU."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark.harness import ROOT


def run_cell(root, workload):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_cell(ROOT, "enhance-flagship-r256")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_fewer_cards_than_the_cell_asks_for(tmp_path):
    """A four-card cell (in a copy of the benchmark with its entry) on a
    machine with fewer cards."""
    import json
    import shutil

    import torch

    from benchmark.tests.mesh_cell import NAME, spec_with_mesh

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_with_mesh()))
    shutil.copytree(ROOT / "sddm_tpu_torch", tmp_path / "sddm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    out = run_cell(tmp_path, NAME)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 4 CUDA card(s)" in out.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails without a result (the program is not there)."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; from benchmark.run import main; "
            "sys.exit(main(['--workload', 'enhance-flagship-r256', '--seed', '1', "
            "'--seconds', '1']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "sddm_tpu_torch" in out.stderr
