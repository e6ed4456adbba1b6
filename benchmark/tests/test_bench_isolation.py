"""What the benchmark runs loads neither JAX nor the JAX package, and the
plain references load nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.harness import FORBIDDEN, ROOT

HARNESS = """
import json, sys
import benchmark.run, benchmark.worker, benchmark.harness, benchmark.cells, benchmark.control
import benchmark.inputs, benchmark.tracing
from benchmark import harness
spec = harness.load_spec()
for w in spec["workloads"]:
    cell = harness.cell_of(spec, w["name"])
    cell.reference
    for m in cell.per_layer:
        harness.reader_of(cell, m["name"])
import sddm_tpu_torch.enhance, sddm_tpu_torch.specmodel, sddm_tpu_torch.cli
import sddm_tpu_torch.train.trainer, sddm_tpu_torch.parallel.mesh
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCES = """
import json, sys
from benchmark.harness import ROOT, load_file
for p in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
    load_file(p)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_workers_and_references_load_no_jax():
    found = top_level_modules(HARNESS) & set(FORBIDDEN)
    assert not found, f"loaded {found}"


def test_references_load_nothing_of_the_program():
    loaded = top_level_modules(REFERENCES)
    assert "sddm_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)
    # compared whole: the program's name begins with the JAX package's
    assert "sddm_tpu_torch".split(".")[0] != "sddm_tpu"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "sddm_tpu_torch_lookalike", sys)
    assert "sddm_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()
