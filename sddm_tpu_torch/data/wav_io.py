"""WAV file IO on the host (counterpart of ``sddm_tpu/data/wav_io.py``,
its scipy path): PCM16/PCM32/PCM8/float WAVs through ``scipy.io.wavfile``,
normalized to float32 in [-1, 1]; written as PCM16."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def load_wav(path) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (audio [channels, samples] float32 in [-1, 1], rate)."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64
        audio = data.astype(np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    else:
        audio = audio.T  # scipy gives [samples, channels]
    return audio, int(sr)


def load_wav_i16(path) -> Tuple[np.ndarray, int]:
    """Read a PCM16 WAV without float conversion -> ([channels, samples]
    int16, rate): the backing store of the datasets' RAM cache."""
    sr, data = wavfile.read(str(path))
    if data.dtype != np.int16:
        raise ValueError(f"{path}: RAM cache requires PCM16 WAVs, got {data.dtype}")
    audio = data[None, :] if data.ndim == 1 else data.T
    return np.ascontiguousarray(audio), int(sr)


def save_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1, 1] audio ([samples], [1, samples] or [channels,
    samples]) as PCM16."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio.T if audio.shape[0] < audio.shape[1] else audio
        if audio.shape[1] == 1:
            audio = audio[:, 0]
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(str(path), sample_rate, pcm)
