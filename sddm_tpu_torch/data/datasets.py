"""Host-side datasets (counterpart of ``sddm_tpu/data/datasets.py``): numpy
arrays on the host, which the entry points move to the device in batches."""

from __future__ import annotations

from math import ceil
from pathlib import Path
from typing import List, Tuple

import numpy as np

from .wav_io import load_wav, load_wav_i16

_DATATYPES = (".wav", ".logwav.npy", ".spec.npy", ".mel.npy")


def generate_inventory(path, file_type: str = ".wav") -> List[str]:
    """The sorted names of the ``file_type`` files in ``path``."""
    path = Path(path)
    if not path.is_dir():
        raise NotADirectoryError(f"{path} is not a valid directory")
    names = sorted(p.name for p in path.glob("*" + file_type))
    if not names:
        raise FileNotFoundError(f"{path} has no valid {file_type} file")
    return names


class AudioDataset:
    """Paired clean/noisy utterances with a random T-sample crop or a zero
    pad.  ``seed`` seeds the crops; ``cache="ram"`` keeps each decoded pair
    as int16 PCM after its first read (PCM16 ``.wav`` only)."""

    def __init__(self, data_root, datatype, sample_rate=8000, T=-1, seed=0, cache=None):
        if datatype not in _DATATYPES:
            raise NotImplementedError(datatype)
        if cache not in (None, "ram"):
            raise ValueError(f"cache must be None or 'ram', got {cache!r}")
        if cache == "ram" and datatype != ".wav":
            raise ValueError("cache='ram' is only supported for .wav data")
        self.datatype = datatype
        self.sample_rate = sample_rate
        self.T = T
        self.clean_path = Path(f"{data_root}/clean")
        self.noisy_path = Path(f"{data_root}/noisy")
        self.inventory = generate_inventory(self.clean_path, datatype)
        self.data_len = len(self.inventory)
        self.rng = np.random.default_rng(seed)
        self.cache = cache
        self._cache_store = {} if cache else None

    def _cached_pair_i16(self, index):
        hit = self._cache_store.get(index)
        if hit is None:
            name = self.inventory[index]
            clean, sr1 = load_wav_i16(self.clean_path / name)
            noisy, sr2 = load_wav_i16(self.noisy_path / name)
            for sr in (sr1, sr2):
                if sr != self.sample_rate:
                    raise ValueError(f"{name}: rate {sr} != {self.sample_rate}")
            if noisy.shape[-1] != clean.shape[-1]:
                raise ValueError("clean/noisy length mismatch")
            hit = (clean, noisy)
            self._cache_store[index] = hit  # dict set is atomic under the GIL
        return hit

    def __len__(self):
        return self.data_len

    def _load_pair(self, index) -> Tuple[np.ndarray, np.ndarray]:
        name = self.inventory[index]
        if self.datatype == ".wav":
            clean, sr = load_wav(self.clean_path / name)
            if sr != self.sample_rate:
                raise ValueError(f"{name}: rate {sr} != {self.sample_rate}")
            noisy, sr = load_wav(self.noisy_path / name)
            if sr != self.sample_rate:
                raise ValueError(f"{name}: rate {sr} != {self.sample_rate}")
        else:
            clean = np.load(self.clean_path / name)
            noisy = np.load(self.noisy_path / name)
            if clean.ndim == 1:
                clean, noisy = clean[None, :], noisy[None, :]
        return clean.astype(np.float32), noisy.astype(np.float32)

    def _crop_or_pad(self, clean, noisy):
        n = clean.shape[-1]
        if n > self.T > 0:
            start = int(self.rng.integers(0, n - self.T))
            clean = clean[:, start : start + self.T]
            noisy = noisy[:, start : start + self.T]
        elif self.T > n > 0:
            pad = self.T - n
            clean = np.pad(clean, ((0, 0), (0, pad)))
            noisy = np.pad(noisy, ((0, 0), (0, pad)))
        return clean, noisy

    def __getitem__(self, index):
        if self.cache == "ram":
            clean, noisy = self._crop_or_pad(*self._cached_pair_i16(index))
            return np.ascontiguousarray(clean), np.ascontiguousarray(noisy), index

        clean, noisy = self._load_pair(index)
        if self.datatype in (".wav", ".logwav.npy"):
            if clean.shape[-1] != noisy.shape[-1]:
                raise ValueError("clean/noisy length mismatch")
            clean, noisy = self._crop_or_pad(clean, noisy)
        return clean, noisy, index

    def get_name(self, idx) -> str:
        if self.datatype == ".wav":
            return self.inventory[idx].rsplit(".", 1)[0]
        return self.inventory[idx].rsplit(".", 2)[0]


class InferDataset(AudioDataset):
    """Each utterance zero-padded to a multiple of T and stacked as rows
    ``[n_chunk, 1, T]``, with the file index of every row."""

    def __getitem__(self, index):
        if self.datatype not in (".wav", ".logwav.npy"):
            raise NotImplementedError(self.datatype)
        clean, noisy = self._load_pair(index)
        n = clean.shape[-1]
        if n != noisy.shape[-1]:
            raise ValueError("clean/noisy length mismatch")
        n_chunk = ceil(n / self.T)
        pad = n_chunk * self.T - n
        clean = np.pad(clean, ((0, 0), (0, pad)))
        noisy = np.pad(noisy, ((0, 0), (0, pad)))
        index_arr = index * np.ones(n_chunk, dtype=np.int64)
        return clean.reshape(n_chunk, 1, self.T), noisy.reshape(n_chunk, 1, self.T), index_arr


class OutputDataset:
    """target/condition/output triplets of a results dir."""

    def __init__(self, data_root, datatype, sample_rate=8000, T=-1):
        if datatype not in (".wav",):
            raise NotImplementedError(datatype)
        self.datatype = datatype
        self.sample_rate = sample_rate
        self.clean_path = Path(f"{data_root}/target")
        self.noisy_path = Path(f"{data_root}/condition")
        self.output_path = Path(f"{data_root}/output")
        self.inventory = sorted(generate_inventory(self.output_path, datatype))
        self.data_len = len(self.inventory)

    def __len__(self):
        return self.data_len

    def __getitem__(self, index):
        name = self.inventory[index]
        out = []
        for path in (self.clean_path, self.noisy_path, self.output_path):
            audio, sr = load_wav(path / name)
            if sr != self.sample_rate:
                raise ValueError(f"{name}: rate {sr} != {self.sample_rate}")
            out.append(audio)
        return tuple(out)

    def get_name(self, idx) -> str:
        return self.inventory[idx].rsplit(".", 1)[0]


class NumpyDataset:
    """Clean audio and noisy spectrogram records of the vocoder path."""

    def __init__(self, data_root, datatype, sample_rate=8000, T=-1):
        if datatype not in (".wav", ".spec.npy", ".mel.npy"):
            raise NotImplementedError(datatype)
        self.datatype = datatype
        self.sample_rate = sample_rate
        self.T = T
        self.clean_path = Path(f"{data_root}/clean")
        self.noisy_path = Path(f"{data_root}/noisy")
        self.inventory = generate_inventory(self.clean_path, ".wav")
        self.data_len = len(self.inventory)

    def __len__(self):
        return self.data_len

    def __getitem__(self, idx):
        name = self.inventory[idx]
        audio, _sr = load_wav(self.clean_path / name)
        record = {"audio": audio.astype(np.float32), "index": idx}
        if self.datatype in (".spec.npy", ".mel.npy"):
            record["spectrogram"] = np.load(
                self.noisy_path / f"{name}{self.datatype}").astype(np.float32)
        return record

    def get_name(self, idx) -> str:
        return self.inventory[idx].split(".", 1)[0]
