"""Short-Time Objective Intelligibility (STOI), numpy implementation.

A copy of ``sddm_tpu/ops/stoi.py`` (host numpy and scipy in both
packages), so that the port scores as the JAX package does.

Implements the classic STOI measure (Taal, Hendriks, Heusdens, Jensen 2011):
10 kHz resampling, 512-point STFT of 256-sample 50%-overlap Hann frames,
silent-frame removal at 40 dB range, 15 one-third-octave bands from 150 Hz,
384 ms (30-frame) analysis segments, -15 dB SDR clipping, and averaged
band/segment correlation.

The reference relies on torchmetrics' STOI wrapper (evaluate_results.py:22),
which wraps pystoi; this is an independent implementation of the published
algorithm (host-side, like the reference's usage).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS = 10000          # internal sample rate
N_FRAME = 256       # frame length at 10 kHz
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30              # frames per analysis segment (384 ms)
BETA = -15.0        # lower SDR bound (dB)
DYN_RANGE = 40.0    # silent-frame removal range (dB)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """One-third octave band matrix [num_bands, nfft//2 + 1]."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = cf * 2.0 ** (-1.0 / 6.0)
    freq_high = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def _stft_frames(x: np.ndarray) -> np.ndarray:
    """[n_frames, NFFT//2+1] magnitude-preserving complex STFT."""
    hop = N_FRAME // 2
    n_frames = max(0, (len(x) - N_FRAME) // hop + 1)
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = np.stack(
        [x[i * hop : i * hop + N_FRAME] * w for i in range(n_frames)]
    )
    return np.fft.rfft(frames, n=NFFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    n_frames = (len(x) - N_FRAME) // hop + 1
    frames_x = np.stack(
        [x[i * hop : i * hop + N_FRAME] * w for i in range(n_frames)]
    )
    frames_y = np.stack(
        [y[i * hop : i * hop + N_FRAME] * w for i in range(n_frames)]
    )
    energies = 20 * np.log10(np.linalg.norm(frames_x, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - DYN_RANGE)
    frames_x, frames_y = frames_x[mask], frames_y[mask]
    # overlap-add back to signals
    n_out = (len(frames_x) - 1) * hop + N_FRAME if len(frames_x) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(frames_x)):
        xs[i * hop : i * hop + N_FRAME] += frames_x[i]
        ys[i * hop : i * hop + N_FRAME] += frames_y[i]
    return xs, ys


def stoi(clean: np.ndarray, denoised: np.ndarray, fs: int) -> float:
    """STOI in [~0, 1]; higher is better."""
    clean = np.asarray(clean, dtype=np.float64).reshape(-1)
    denoised = np.asarray(denoised, dtype=np.float64).reshape(-1)
    if len(clean) != len(denoised):
        raise ValueError("signals must be equal length")
    if fs != FS:
        g = np.gcd(FS, fs)
        clean = resample_poly(clean, FS // g, fs // g)
        denoised = resample_poly(denoised, FS // g, fs // g)

    # too short to form even one frame -> no intelligibility estimate
    if len(clean) < N_FRAME:
        return 1e-5

    clean, denoised = _remove_silent_frames(clean, denoised)
    if len(clean) < N_FRAME * 2:
        return 1e-5

    obm = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    X = np.abs(_stft_frames(clean)) ** 2     # [frames, bins]
    Y = np.abs(_stft_frames(denoised)) ** 2
    # third-octave band envelopes [frames, bands]
    Xb = np.sqrt(X @ obm.T)
    Yb = np.sqrt(Y @ obm.T)
    if Xb.shape[0] < N:
        return 1e-5

    d_sum = 0.0
    count = 0
    for m in range(N, Xb.shape[0] + 1):
        seg_x = Xb[m - N : m]  # [N, bands]
        seg_y = Yb[m - N : m]
        # normalize + clip
        alpha = np.sqrt(
            np.sum(seg_x**2, axis=0) / (np.sum(seg_y**2, axis=0) + 1e-12)
        )
        seg_y_n = seg_y * alpha[None, :]
        seg_y_n = np.minimum(seg_y_n, seg_x * (1 + 10 ** (-BETA / 20)))
        # per-band correlation
        xm = seg_x - seg_x.mean(axis=0, keepdims=True)
        ym = seg_y_n - seg_y_n.mean(axis=0, keepdims=True)
        num = np.sum(xm * ym, axis=0)
        den = np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12
        d_sum += float(np.sum(num / den))
        count += NUM_BANDS
    return d_sum / count
