"""The PyTorch port stands alone: no file of ``sddm_tpu_torch/`` and not
``chip_smoke.py`` imports JAX, flax, msgpack or the JAX package (the card's
machine has none of them), and none builds through
``torch.utils.cpp_extension`` or Triton (the kernels are CUDA C++ built by
nvcc and loaded with ctypes).  ``chip_smoke.py`` fails without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "sddm_tpu", "triton",
             "torch.utils.cpp_extension")
FILES = sorted((ROOT / "sddm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for expected in ("sddm_tpu_torch/ops/gn_silu.py", "sddm_tpu_torch/enhance.py",
                     "sddm_tpu_torch/train/checkpoints.py", "sddm_tpu_torch/ops/diffwave_stack.py",
                     "sddm_tpu_torch/specmodel.py", "sddm_tpu_torch/ops/packed.py",
                     "sddm_tpu_torch/models/unet_packed.py", "sddm_tpu_torch/infer.py",
                     "sddm_tpu_torch/evaluate.py", "sddm_tpu_torch/evaluate_results.py",
                     "sddm_tpu_torch/make_synthetic_corpus.py",
                     "sddm_tpu_torch/utils/config.py", "sddm_tpu_torch/utils/logging.py",
                     "sddm_tpu_torch/utils/util.py", "sddm_tpu_torch/data/wav_io.py",
                     "sddm_tpu_torch/data/datasets.py", "sddm_tpu_torch/data/loaders.py",
                     "sddm_tpu_torch/data/synth.py", "sddm_tpu_torch/ops/logaudio.py",
                     "sddm_tpu_torch/ops/stoi.py", "sddm_tpu_torch/ops/pesq_approx.py",
                     "sddm_tpu_torch/models/losses.py", "sddm_tpu_torch/models/metrics.py",
                     "chip_smoke.py"):
        assert expected in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom sddm_tpu.models import SDDM\n"
                   "from torch.utils import cpp_extension\nimport sddm_tpu_torch\n")
    assert [n for n in _imports(src) if _forbidden(n)] == [
        "jax.numpy", "sddm_tpu.models", "sddm_tpu.models.SDDM",
        "torch.utils.cpp_extension"]


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
