"""STFT and mel spectrogram features (counterpart of
``sddm_tpu/ops/spectrogram.py``).

The features of the reference's ``prepare_spectrogram.py``: a periodic
Hamming window, ``power=1``, normalised by ``sqrt(sum(window**2))``, centre
reflect padding, the HTK mel scale with ``f_min=20``, then a log10
compression to [0, 1].  Frames are taken with ``unfold`` and transformed with
``torch.fft.rfft``; the normalisation is divided out here, since
``torch.stft(normalized=True)`` divides by another factor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hamming_window(n: int, periodic: bool = True) -> np.ndarray:
    m = n if periodic else n - 1
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / m)


def _frame_for_stft(audio: torch.Tensor, n_fft: int, hop: int,
                    center: bool = True) -> torch.Tensor:
    """Reflect-pad by ``n_fft // 2`` on both sides (``center``), then cut
    ``[..., n_frames, n_fft]`` frames; a tail shorter than a hop is dropped."""
    if center:
        pad = n_fft // 2
        lead = audio.shape[:-1]
        audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad),
                      mode="reflect").reshape(*lead, -1)
    return audio.unfold(-1, n_fft, hop)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop_samples: int,
                   normalized: bool = True, center: bool = True) -> torch.Tensor:
    """|STFT| with a periodic Hamming window; ``[..., T]`` -> ``[..., freq, time]``."""
    window = hamming_window(n_fft)
    frames = _frame_for_stft(audio, n_fft, hop_samples, center) * torch.as_tensor(
        window, dtype=audio.dtype, device=audio.device)
    spec = torch.fft.rfft(frames, dim=-1).abs()  # [..., time, freq]
    if normalized:
        spec = spec / np.sqrt((window**2).sum())
    return spec.transpose(-1, -2)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 20.0,
                   f_max: float | None = None) -> np.ndarray:
    """HTK-scale triangular mel filterbank ``[n_freqs, n_mels]`` (torchaudio
    ``melscale_fbanks`` with ``norm=None``)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def mel_spectrogram(audio: torch.Tensor, n_fft: int, hop_samples: int, n_mels: int,
                    sample_rate: int, f_min: float = 20.0, f_max: float | None = None,
                    center: bool = True) -> torch.Tensor:
    """Mel-scale |STFT| ``[..., n_mels, time]``."""
    spec = stft_magnitude(audio, n_fft, hop_samples, center=center)
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max),
                         dtype=spec.dtype, device=spec.device)
    return torch.einsum("...ft,fm->...mt", spec, fb)


def log_compress(spec: torch.Tensor) -> torch.Tensor:
    """``clip((log10(spec) - 1 + 5) / 5, 0, 1)``."""
    return torch.clamp((torch.log10(spec) - 1.0 + 5.0) / 5.0, 0.0, 1.0)


def make_feature_fn(kind: str, n_fft: int, hop_samples: int, n_mels: int | None = None,
                    sample_rate: int | None = None):
    """A feature extractor ``[B, 1, T] -> [B, freq, T // hop]``: |STFT|
    (``kind="spec"``) or mel (``kind="mel"``), log-compressed.  The centred
    STFT gives ``1 + T // hop`` frames; the last is dropped so that
    ``frames * hop == T``."""

    def fn(audio: torch.Tensor) -> torch.Tensor:
        a = audio[:, 0, :]
        if kind == "mel":
            spec = mel_spectrogram(a, n_fft, hop_samples, n_mels, sample_rate)
        else:
            spec = stft_magnitude(a, n_fft, hop_samples)
        return log_compress(spec)[..., : audio.shape[-1] // hop_samples]

    return fn
