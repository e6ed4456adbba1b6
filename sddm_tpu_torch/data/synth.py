"""Reproducible synthetic speech-shaped corpus generator (a copy of
``sddm_tpu/data/synth.py``, so that the port regenerates the JAX package's
corpora byte for byte).

A deterministic source-filter corpus shaped like the enhancement task:
glottal-pulse excitation through time-varying formant resonators
("clean"), mixed with colored/babble/machine noise at VoiceBank-style SNRs
("noisy").  Everything is seeded numpy: the same (seed, index, version)
always regenerates the identical utterance.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

from .wav_io import save_wav

SR = 16000

# vowel-ish formant targets (F1, F2, F3) in Hz
_VOWELS = np.array([
    [730, 1090, 2440],   # /a/
    [270, 2290, 3010],   # /i/
    [300, 870, 2240],    # /u/
    [530, 1840, 2480],   # /e/
    [570, 840, 2410],    # /o/
    [660, 1720, 2410],   # /ae/
], dtype=np.float64)


def _resonator(freq: float, bw: float, sr: int):
    """Second-order all-pole formant resonator coefficients."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = [1.0, -2 * r * np.cos(theta), r * r]
    return [1.0 - r], a


def _glottal_pulse_train(rng, n, f0_start, f0_end, sr):
    """Impulse train with declining f0 contour + jitter, smoothed into a
    glottal-ish pulse by a leaky integrator."""
    f0 = np.linspace(f0_start, f0_end, n)
    f0 = f0 * (1.0 + 0.02 * rng.standard_normal(n).cumsum() / np.sqrt(n))
    phase = np.cumsum(np.clip(f0, 50, 400)) / sr
    exc = np.zeros(n)
    exc[np.searchsorted(phase, np.arange(1, int(phase[-1]) + 1))
        .clip(0, n - 1)] = 1.0
    # -12 dB/oct glottal spectral tilt
    return signal.lfilter([1.0], [1.0, -0.95], exc)


def _voiced_segment(rng, n, sr):
    f0 = rng.uniform(85, 255)
    exc = _glottal_pulse_train(rng, n, f0, f0 * rng.uniform(0.8, 1.0), sr)
    vowel = _VOWELS[rng.integers(len(_VOWELS))]
    out = exc
    for f, bw in zip(vowel * rng.uniform(0.92, 1.08, 3),
                     (rng.uniform(50, 90), rng.uniform(70, 120),
                      rng.uniform(110, 180))):
        b, a = _resonator(f, bw, sr)
        out = signal.lfilter(b, a, out)
    return out


def _unvoiced_segment(rng, n, sr):
    lo = rng.uniform(1500, 3000)
    hi = rng.uniform(5000, 7600)
    sos = signal.butter(2, [lo, hi], btype="band", fs=sr, output="sos")
    return signal.sosfilt(sos, rng.standard_normal(n)) * 0.4


def synth_clean(rng: np.random.Generator, duration_s: float = 3.0,
                sr: int = SR) -> np.ndarray:
    """One speech-shaped utterance: syllable sequence of voiced / unvoiced /
    silent segments with raised-cosine syllabic envelopes."""
    n_total = int(duration_s * sr)
    out = np.zeros(n_total)
    pos = 0
    while pos < n_total:
        kind = rng.choice(["v", "v", "v", "u", "sil"])
        dur = int(rng.uniform(0.06, 0.28) * sr)
        dur = min(dur, n_total - pos)
        if kind == "v":
            seg = _voiced_segment(rng, dur, sr)
        elif kind == "u":
            seg = _unvoiced_segment(rng, dur, sr)
        else:
            seg = np.zeros(dur)
        if kind != "sil" and dur > 32:
            ramp = min(dur // 4, int(0.02 * sr))
            env = np.ones(dur)
            env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
            env[-ramp:] = env[:ramp][::-1]
            seg = seg * env * rng.uniform(0.5, 1.0)
        out[pos:pos + dur] = seg
        pos += dur
    peak = np.max(np.abs(out)) + 1e-9
    return (out / peak * 0.5).astype(np.float32)


def _pink_noise(rng, n):
    spec = (np.fft.rfft(rng.standard_normal(n))
            / np.sqrt(np.maximum(np.arange(n // 2 + 1), 1)))
    return np.fft.irfft(spec, n)


def _hum_noise(rng, n, sr):
    t = np.arange(n) / sr
    base = rng.uniform(49, 61)
    hum = sum(rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * base * k * t
                                             + rng.uniform(0, 2 * np.pi))
              for k in range(1, 5))
    am = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t)
    return hum + 0.3 * am * rng.standard_normal(n)


def _babble_noise(rng, n, sr):
    out = np.zeros(n)
    for _ in range(6):
        u = synth_clean(rng, n / sr, sr)[:n]
        out[:len(u)] += u
    return out


def synth_noise(rng: np.random.Generator, n: int, sr: int = SR) -> np.ndarray:
    kind = rng.choice(["white", "pink", "babble", "hum"])
    if kind == "white":
        noise = rng.standard_normal(n)
    elif kind == "pink":
        noise = _pink_noise(rng, n)
    elif kind == "babble":
        noise = _babble_noise(rng, n, sr)
    else:
        noise = _hum_noise(rng, n, sr)
    return noise.astype(np.float32)


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """Mix to the target SNR; returns (clean, noisy) scaled by one shared
    factor when the mix would clip PCM16, so the pair stays aligned."""
    noise = noise[:len(clean)]
    p_clean = np.mean(clean ** 2) + 1e-12
    p_noise = np.mean(noise ** 2) + 1e-12
    scale = np.sqrt(p_clean / (p_noise * 10 ** (snr_db / 10)))
    noisy = clean + scale * noise
    peak = np.max(np.abs(noisy))
    if peak > 0.99:
        noisy = noisy / peak * 0.99
        clean = clean / peak * 0.99
    return clean.astype(np.float32), noisy.astype(np.float32)


# ---------------------------------------------------------------------------
# Corpus v2: speech-shaped material that keeps the STOI metric meaningful.
#
# v1's failure mode (round-3 verdict): per-segment random gains + peak-only
# utterance normalization produced files dominated by near-silence with one
# loud burst, so STOI's 40 dB silent-frame gate kept <30 frames and the
# metric degenerated (stoi(clean,clean) -> early-return).  v2 fixes the
# corpus, not the metric: per-syllable RMS equalization (+-4 dB), capped
# inter-syllable silence, aspiration noise inside voiced nuclei (broadband
# third-octave envelopes up to ~5 kHz), and utterance-level f0 contours with
# rises AND falls.  Syllable nuclei of 90-240 ms + short gaps give the
# 2-8 Hz syllabic amplitude modulation STOI's 384 ms analysis window needs.
# ---------------------------------------------------------------------------


def _f0_contour_v2(rng, n):
    """Utterance-level f0 contour: smooth random walk with rises and falls."""
    base = rng.uniform(90, 240)
    n_knots = max(4, int(n / SR * 3))
    knots = base * 2.0 ** rng.uniform(-0.35, 0.35, n_knots)
    return np.interp(np.linspace(0, 1, n), np.linspace(0, 1, n_knots), knots)


def _voiced_segment_v2(rng, f0_slice, sr):
    """Voiced nucleus: glottal pulses + aspiration noise through shared
    formant resonators; the aspiration keeps every STOI band non-degenerate."""
    n = len(f0_slice)
    phase = np.cumsum(np.clip(f0_slice, 60, 400)) / sr
    exc = np.zeros(n)
    exc[np.searchsorted(phase, np.arange(1, int(phase[-1]) + 1))
        .clip(0, n - 1)] = 1.0
    exc = signal.lfilter([1.0], [1.0, -0.95], exc)  # -12 dB/oct tilt
    breath = rng.standard_normal(n) * 10.0 ** (rng.uniform(-22, -14) / 20.0) \
        * (np.sqrt(np.mean(exc ** 2)) + 1e-9) * 12.0
    out = exc + breath
    vowel = _VOWELS[rng.integers(len(_VOWELS))]
    for f, bw in zip(vowel * rng.uniform(0.92, 1.08, 3),
                     (rng.uniform(50, 90), rng.uniform(70, 120),
                      rng.uniform(110, 180))):
        b, a = _resonator(f, bw, sr)
        out = signal.lfilter(b, a, out)
    # gentle broadband floor so 3-5 kHz third-octave bands carry real
    # (envelope-modulated) energy rather than PCM16 quantization noise
    sos = signal.butter(2, 2500, btype="high", fs=sr, output="sos")
    out = out + signal.sosfilt(sos, rng.standard_normal(n)) \
        * 10.0 ** (-26 / 20.0) * (np.sqrt(np.mean(out ** 2)) + 1e-9) * 8.0
    return out


def synth_clean_v2(rng: np.random.Generator, duration_s: float = 3.0,
                   sr: int = SR) -> np.ndarray:
    """Speech-shaped utterance v2: syllable train (optional consonant onset +
    voiced nucleus) with per-syllable RMS equalization and capped silence."""
    n_total = int(duration_s * sr)
    f0 = _f0_contour_v2(rng, n_total)
    out = np.zeros(n_total)
    pos = int(rng.uniform(0, 0.04) * sr)
    target_rms = 0.05
    while pos < n_total - 256:
        # optional unvoiced onset (frication burst)
        if rng.random() < 0.45:
            dur = min(int(rng.uniform(0.03, 0.12) * sr), n_total - pos)
            seg = _unvoiced_segment(rng, dur, sr)
            seg = seg / (np.sqrt(np.mean(seg ** 2)) + 1e-9) * target_rms \
                * 10.0 ** (rng.uniform(-6, -2) / 20.0)
            out[pos:pos + dur] = _cos_ramp(seg, sr)
            pos += dur
        # voiced nucleus, 90-240 ms
        dur = min(int(rng.uniform(0.09, 0.24) * sr), n_total - pos)
        if dur > 64:
            seg = _voiced_segment_v2(rng, f0[pos:pos + dur], sr)
            seg = seg / (np.sqrt(np.mean(seg ** 2)) + 1e-9) * target_rms \
                * 10.0 ** (rng.uniform(-4, 4) / 20.0)
            out[pos:pos + dur] = _cos_ramp(seg, sr)
            pos += dur
        # short inter-syllable gap; occasional word pause, silence capped
        gap = rng.uniform(0.0, 0.06)
        if rng.random() < 0.18:
            gap += rng.uniform(0.05, 0.15)
        pos += int(gap * sr)
    rms = np.sqrt(np.mean(out ** 2)) + 1e-9
    out = out * (target_rms / rms)
    peak = np.max(np.abs(out))
    if peak > 0.6:
        out = out / peak * 0.6
    return out.astype(np.float32)


def _cos_ramp(seg, sr):
    dur = len(seg)
    ramp = min(dur // 4, int(0.015 * sr))
    if ramp > 1:
        env = np.ones(dur)
        env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        env[-ramp:] = env[:ramp][::-1]
        seg = seg * env
    return seg


def _babble_noise_v2(rng, n, sr):
    out = np.zeros(n)
    for _ in range(6):
        u = synth_clean_v2(rng, n / sr, sr)[:n]
        out[:len(u)] += u
    return out


def synth_noise_v2(rng: np.random.Generator, n: int, sr: int = SR
                   ) -> np.ndarray:
    kind = rng.choice(["white", "pink", "babble", "hum"])
    if kind == "white":
        noise = rng.standard_normal(n)
    elif kind == "pink":
        noise = _pink_noise(rng, n)
    elif kind == "babble":
        noise = _babble_noise_v2(rng, n, sr)
    else:
        noise = _hum_noise(rng, n, sr)
    return noise.astype(np.float32)


# VoiceBank-DEMAND SNR grids (train: 0/5/10/15 dB, test: 2.5..17.5 dB)
TRAIN_SNRS = (0.0, 5.0, 10.0, 15.0)
TEST_SNRS = (2.5, 7.5, 12.5, 17.5)
# Low-SNR eval grid: the standard test grid shifted 10 dB down so STOI and
# pesq_approx operate out of their saturated >0.92 band (round-4 verdict:
# corpus-average noisy STOI was 0.922 on the standard test split).
HARD_SNRS = (-7.5, -2.5, 2.5, 7.5)


def generate_corpus(root, n_utterances: int, seed: int, split: str = "train",
                    min_s: float = 2.0, max_s: float = 4.0, sr: int = SR,
                    version: int = 2) -> None:
    """Write ``<root>/{clean,noisy}/u####.wav`` pairs, deterministic in
    (seed, index, version). SNRs rotate through the VoiceBank-style grid.

    version=2 (default) is the STOI-meaningful corpus (per-syllable RMS
    equalization, aspiration noise, capped silence); version=1 reproduces
    the round-1..3 corpus exactly.
    """
    import os

    clean_fn = synth_clean_v2 if version == 2 else synth_clean
    noise_fn = synth_noise_v2 if version == 2 else synth_noise
    snrs = {"train": TRAIN_SNRS, "test": TEST_SNRS,
            "test_hard": HARD_SNRS}[split]
    os.makedirs(os.path.join(root, "clean"), exist_ok=True)
    os.makedirs(os.path.join(root, "noisy"), exist_ok=True)
    for i in range(n_utterances):
        rng = np.random.default_rng([seed, i])
        dur = rng.uniform(min_s, max_s)
        clean = clean_fn(rng, dur, sr)
        noise = noise_fn(rng, len(clean), sr)
        snr = float(snrs[i % len(snrs)])
        clean, noisy = mix_at_snr(clean, noise, snr)
        name = f"u{i:04d}.wav"
        save_wav(os.path.join(root, "clean", name), clean, sr)
        save_wav(os.path.join(root, "noisy", name), noisy, sr)
