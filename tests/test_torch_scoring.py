"""The port's scoring against the JAX package's, on seeded signals.

- Losses (``models/losses.py``) on torch tensors against the jnp functions
  in float32: rtol 1e-6 (one reduction summed in another order).
- ``sisnr`` and ``segment_sisnr`` (``models/metrics.py``) in float32: atol
  1e-4 dB, with an all-zero clean segment (finite, the eps guard's label)
  and a noise-free one.
- The host scorers, ``stoi``, ``pesq_approx`` (wb and nb) and ``sisnr_np``:
  the same numpy code in both packages, held to atol 1e-9.
- ``evaluate`` and ``load_results`` over a 3-file WAV folder: the returned
  dicts and the saved ``.npy`` vectors within 1e-9.
- ``python -m sddm_tpu_torch.evaluate_results`` on that folder, scoring and
  ``--load``.
- ``log_modulus_normalize`` and its inverse against the jnp functions.
"""

import logging
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu import evaluate as jevaluate
from sddm_tpu.data.wav_io import save_wav as jax_save_wav
from sddm_tpu.models import losses as jlosses
from sddm_tpu.models import metrics as jmetrics
from sddm_tpu.ops import logaudio as jlogaudio
from sddm_tpu.ops.pesq_approx import pesq_approx as jax_pesq_approx
from sddm_tpu.ops.stoi import stoi as jax_stoi
from sddm_tpu_torch import evaluate as tevaluate
from sddm_tpu_torch import evaluate_results
from sddm_tpu_torch.models import losses, metrics
from sddm_tpu_torch.ops import logaudio
from sddm_tpu_torch.ops.pesq_approx import pesq_approx
from sddm_tpu_torch.ops.stoi import stoi

HOST_ATOL = 1e-9
SISNR_ATOL = 1e-4  # dB


def _speech(rng, n, sr=16000):
    """A voiced-like test signal: harmonics under a syllable-rate envelope."""
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 220)
    voiced = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    return (0.2 * env * voiced).astype(np.float32)


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "log_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((4, 1, 300)).astype(np.float32)
    target = rng.standard_normal((4, 1, 300)).astype(np.float32)
    target[1] = pred[1]  # a row with no error: log_loss's clamp
    got = float(losses.get_loss(name)(torch.from_numpy(pred), torch.from_numpy(target)))
    want = float(jlosses.get_loss(name)(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 1, 500), (3, 500)])
def test_sisnr_matches_jax(shape):
    rng = np.random.default_rng(1)
    s = rng.standard_normal(shape).astype(np.float32)
    s_hat = (s + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    got = float(metrics.get_metric("sisnr")(torch.from_numpy(s_hat), torch.from_numpy(s)))
    want = float(jmetrics.get_metric("sisnr")(jnp.asarray(s_hat), jnp.asarray(s)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SISNR_ATOL)


def test_segment_sisnr_matches_jax_with_degenerate_segments():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s_hat = (s + 0.5 * rng.standard_normal(s.shape)).astype(np.float32)
    s[0, 1] = 0.0  # an all-zero clean segment
    # a noise-free segment whose every sum and product is exact in float32,
    # so that its error is exactly 0 in any order of summation (the eps
    # guard's +80 dB branch, where the unguarded formula takes log10(inf))
    s[1, 3] = np.tile([1.0, -2.0, 0.5, 0.5], 16)
    s_hat[1, 3] = s[1, 3]
    got = metrics.segment_sisnr(torch.from_numpy(s_hat), torch.from_numpy(s)).numpy()
    want = np.asarray(jmetrics.segment_sisnr(jnp.asarray(s_hat), jnp.asarray(s)))
    assert got.shape == want.shape == (2, 5)
    assert np.isfinite(got).all()
    assert got[0, 1] < -50 and got[1, 3] > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=SISNR_ATOL)


@pytest.mark.parametrize("fs,n", [(16000, 32000), (8000, 12000), (16000, 200)])
def test_host_scorers_match_jax(fs, n):
    rng = np.random.default_rng(fs + n)
    clean = _speech(rng, n, fs)
    noisy = clean + 0.05 * rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(stoi(clean, noisy, fs), jax_stoi(clean, noisy, fs),
                               rtol=0, atol=HOST_ATOL)
    for mode in ("wb", "nb"):
        np.testing.assert_allclose(pesq_approx(clean, noisy, fs, mode),
                                   jax_pesq_approx(clean, noisy, fs, mode),
                                   rtol=0, atol=HOST_ATOL)
    np.testing.assert_allclose(tevaluate.sisnr_np(noisy, clean),
                               jevaluate.sisnr_np(noisy, clean), rtol=0, atol=HOST_ATOL)


def test_evaluators_are_jaxs():
    got, want = tevaluate.make_evaluators(16000), jevaluate.make_evaluators(16000)
    assert sorted(got) == sorted(want)


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """A results dir of three target/condition/output triplets of 1-2 s."""
    root = tmp_path_factory.mktemp("samples")
    rng = np.random.default_rng(3)
    for i, n in enumerate((16000, 24000, 32000)):
        clean = _speech(rng, n)
        jax_save_wav(root / "target" / f"u{i}.wav", clean, 16000)
        jax_save_wav(root / "condition" / f"u{i}.wav",
                     clean + 0.08 * rng.standard_normal(n).astype(np.float32), 16000)
        jax_save_wav(root / "output" / f"u{i}.wav",
                     clean + 0.02 * rng.standard_normal(n).astype(np.float32), 16000)
    return root


METRICS = {"pesq_wb", "pesq_nb", "sisnr", "stoi"}


def test_evaluate_and_load_results_match_jax(samples, tmp_path):
    shutil.copytree(samples, tmp_path / "t")
    shutil.copytree(samples, tmp_path / "j")
    logger = logging.getLogger("test")
    got = tevaluate.evaluate(tmp_path / "t", ".wav", 16000, METRICS, logger)
    want = jevaluate.evaluate(tmp_path / "j", ".wav", 16000, METRICS, logger)
    assert sorted(got) == sorted(want) and len(got) == 4
    for m in want:
        for side in ("noisy", "output"):
            np.testing.assert_allclose(got[m][side], want[m][side], rtol=0, atol=HOST_ATOL)
        for prefix in ("output", "noisy"):
            a = np.load(tmp_path / "t" / f"{prefix}_{m}.npy")
            b = np.load(tmp_path / "j" / f"{prefix}_{m}.npy")
            assert a.shape == b.shape == (3,)
            np.testing.assert_allclose(a, b, rtol=0, atol=HOST_ATOL)
    assert got["sisnr"]["output"] > got["sisnr"]["noisy"]
    names = sorted(got)
    loaded = tevaluate.load_results(tmp_path / "t", names)
    jloaded = jevaluate.load_results(tmp_path / "j", names)
    assert sorted(loaded) == sorted(jloaded)
    for m in names:
        assert loaded[m]["max_improvement_index"] == jloaded[m]["max_improvement_index"]
        for k in ("output_mean", "noisy_mean", "max_improvement"):
            np.testing.assert_allclose(loaded[m][k], jloaded[m][k], rtol=0, atol=HOST_ATOL)
        assert loaded[m]["output_mean"] == got[m]["output"]
        assert loaded[m]["noisy_mean"] == got[m]["noisy"]


def test_evaluate_results_cli(samples, tmp_path):
    shutil.copytree(samples, tmp_path / "s")
    # pesq_wb from the C library where it is importable, else its approximation
    names = [m for m in tevaluate.make_evaluators(16000) if m.startswith("pesq_wb")]
    names += ["stoi", "sisnr"]
    scored = evaluate_results.main([str(tmp_path / "s"), "--metrics", "pesq_wb", "stoi",
                                    "sisnr"])
    assert sorted(scored) == sorted(names)
    summary = evaluate_results.main([str(tmp_path / "s"), "--load", "--metrics"] + names)
    for m in names:
        assert summary[m]["output_mean"] == scored[m]["output"]
        assert summary[m]["noisy_mean"] == scored[m]["noisy"]


def test_log_modulus_matches_jax():
    x = np.random.default_rng(4).uniform(-0.99, 0.99, (2, 1, 300)).astype(np.float32)
    fwd = logaudio.log_modulus_normalize(torch.from_numpy(x), 3).numpy()
    np.testing.assert_allclose(fwd, np.asarray(jlogaudio.log_modulus_normalize(jnp.asarray(x), 3)),
                               rtol=1e-6, atol=1e-7)
    back = logaudio.log_modulus_normalize_reverse(torch.from_numpy(fwd), 3).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jlogaudio.log_modulus_normalize_reverse(jnp.asarray(fwd), 3)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-6)
