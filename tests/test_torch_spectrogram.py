"""Spectrogram features of the PyTorch port (``sddm_tpu_torch.ops.spectrogram``)
against ``sddm_tpu/ops/spectrogram.py`` on the same seeded numpy audio.

The window and the mel filterbank are host numpy in both and must be equal.
The STFT is computed by two FFT libraries (pocketfft here, XLA's on the
JAX side), float32: magnitudes of unit-scale audio are held to 1e-4 absolute
and relative.  ``log_compress`` divides by 5 after a log10: 1e-5 absolute,
with 1e-6 added for near-empty bins where the log is steep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.ops import spectrogram as jspec
from sddm_tpu_torch.ops import spectrogram as tspec


def _audio(shape, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
    return (tone + 0.1 * rng.standard_normal(shape)).astype(np.float32)


def test_window_and_filterbank_equal():
    for periodic in (True, False):
        np.testing.assert_array_equal(tspec.hamming_window(64, periodic),
                                      jspec.hamming_window(64, periodic))
    np.testing.assert_array_equal(tspec.mel_filterbank(33, 10, 16000),
                                  jspec.mel_filterbank(33, 10, 16000))


@pytest.mark.parametrize("n_fft,hop,T,center", [(64, 16, 512, True), (32, 8, 300, True),
                                               (64, 16, 512, False)])
def test_stft_magnitude_matches_jax(n_fft, hop, T, center):
    audio = _audio((2, T), seed=T + n_fft)
    want = np.asarray(jspec.stft_magnitude(jnp.asarray(audio), n_fft, hop, center=center))
    got = tspec.stft_magnitude(torch.from_numpy(audio), n_fft, hop, center=center).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mel_spectrogram_matches_jax():
    audio = _audio((2, 640), seed=5)
    want = np.asarray(jspec.mel_spectrogram(jnp.asarray(audio), 64, 16, 12, 16000))
    got = tspec.mel_spectrogram(torch.from_numpy(audio), 64, 16, 12, 16000).numpy()
    assert got.shape == want.shape == (2, 12, 41)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_log_compress_matches_jax():
    spec = np.abs(np.random.default_rng(3).standard_normal((4, 50))).astype(np.float32) * 20
    spec[0, :5] = 0.0  # log10(0) = -inf clips to 0 on both sides
    want = np.asarray(jspec.log_compress(jnp.asarray(spec)))
    got = tspec.log_compress(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert (got[0, :5] == 0).all()


@pytest.mark.parametrize("kind", ["spec", "mel"])
def test_feature_fn_matches_jax(kind):
    audio = _audio((2, 1, 512), seed=11)
    args = (kind, 64, 16)
    kw = dict(n_mels=12, sample_rate=16000)
    want = np.asarray(jspec.make_feature_fn(*args, **kw)(jnp.asarray(audio)))
    got = tspec.make_feature_fn(*args, **kw)(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 33 if kind == "spec" else 12, 32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
