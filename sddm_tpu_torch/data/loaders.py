"""Host-side batch loaders (counterpart of ``sddm_tpu/data/loaders.py``).

The batch order is the JAX package's, so one config gives the same batches
in both: the train/validation split shuffles with ``RandomState(0)`` and
every epoch permutes with ``default_rng((seed, epoch))``.  That is why this
is not ``torch.utils.data.DataLoader``, whose order differs.  With
``num_workers > 1`` a thread pool decodes up to two batches ahead of the
consumer; batches are contiguous numpy arrays.  The random crops (the
dataset's ``crop``, the WaveGrad collate) are drawn in the consuming thread,
batch by batch in order, so every worker count gives the batches of one
worker, which are the JAX package's at ``num_workers`` 0.  (The JAX package's
threads draw from the same generators in their own order.)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from .datasets import AudioDataset, InferDataset, NumpyDataset, OutputDataset


def default_collate(items):
    """Stack each tuple field along a new batch axis."""
    first = items[0]
    if isinstance(first, tuple):
        return tuple(np.stack([np.asarray(it[i]) for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


def infer_data_collate(items):
    """Concatenate pre-stacked chunk rows along the batch axis."""
    return tuple(np.concatenate([np.asarray(it[i]) for it in items], axis=0)
                 for i in range(len(items[0])))


class BaseDataLoader:
    """Seeded-split batch iterator."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        validation_split: float = 0.0,
        num_workers: int = 0,
        collate_fn: Callable = default_collate,
        drop_last: bool = False,
        seed: int = 0,
        _indices: Optional[np.ndarray] = None,
        _epoch_shuffle: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.validation_split = validation_split
        self._epoch = 0

        if _indices is not None:
            self.indices = _indices
            self.shuffle = bool(_epoch_shuffle)
            self.valid_indices = None
        elif validation_split == 0.0:
            self.indices = np.arange(len(dataset))
            self.shuffle = shuffle
            self.valid_indices = None
        else:
            n = len(dataset)
            idx_full = np.arange(n)
            np.random.RandomState(0).shuffle(idx_full)
            len_valid = (int(validation_split) if isinstance(validation_split, int)
                         else int(n * validation_split))
            if isinstance(validation_split, int) and not (0 < len_valid < n):
                raise ValueError("validation set size out of range")
            self.valid_indices = idx_full[:len_valid]
            self.indices = idx_full[len_valid:]
            self.shuffle = True  # both subsets sample randomly every epoch

        self.n_samples = len(self.indices)
        self._rng_seed = seed

    def __len__(self) -> int:
        if self.drop_last:
            return self.n_samples // self.batch_size
        return (self.n_samples + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        order = self.indices
        if self.shuffle:
            order = np.random.default_rng((self._rng_seed, self._epoch)).permutation(order)
        self._epoch += 1

        n_batches = len(self)
        batches = [order[i * self.batch_size : (i + 1) * self.batch_size]
                   for i in range(n_batches)]
        # decoding draws nothing; the crops and the collate draw here, in order
        load = getattr(self.dataset, "load", self.dataset.__getitem__)
        crop = getattr(self.dataset, "crop", None)

        def decode(batch_idx):
            return [load(i) for i in batch_idx]

        def finish(decoded):
            return self.collate_fn([crop(it) for it in decoded] if crop else decoded)

        if self.num_workers <= 1:
            for b in batches:
                yield finish(decode(b))
            return
        # each worker decodes a whole batch; up to two batches in flight
        ahead = 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [pool.submit(decode, b) for b in batches[:ahead]]
            for consumed in range(n_batches):
                decoded = futures[consumed].result()
                if consumed + ahead < n_batches:
                    futures.append(pool.submit(decode, batches[consumed + ahead]))
                yield finish(decoded)

    def split_validation(self) -> Optional["BaseDataLoader"]:
        """A loader over the held-out subset, or None without one."""
        if self.valid_indices is None:
            return None
        return BaseDataLoader(self.dataset, self.batch_size, num_workers=self.num_workers,
                              collate_fn=self.collate_fn, _indices=self.valid_indices,
                              _epoch_shuffle=True, seed=self._rng_seed + 1)


class AudioDataLoader(BaseDataLoader):
    def __init__(self, dataset, batch_size, shuffle=True, validation_split=0.0,
                 num_workers=1, drop_last=False):
        super().__init__(dataset, batch_size, shuffle, validation_split, num_workers,
                         drop_last=drop_last)


class InferDataLoader(BaseDataLoader):
    """No shuffle; the chunk-concatenating collate."""

    def __init__(self, dataset, batch_size, num_workers=1):
        super().__init__(dataset, batch_size, shuffle=False, validation_split=0.0,
                         num_workers=num_workers, collate_fn=infer_data_collate)


class _WaveGradCollator:
    """A random ``crop_mel_frames`` crop aligned to ``hop_samples``; records
    shorter than the crop are dropped."""

    def __init__(self, hop_samples, crop_mel_frames, seed=0):
        self.hop_samples = hop_samples
        self.crop_mel_frames = crop_mel_frames
        self.rng = np.random.default_rng(seed)

    def __call__(self, minibatch):
        audios, specs, indices = [], [], []
        for record in minibatch:
            spec = record["spectrogram"]
            if spec.shape[-1] < self.crop_mel_frames:
                continue
            start = int(self.rng.integers(0, spec.shape[-1] - self.crop_mel_frames + 1))
            end = start + self.crop_mel_frames
            specs.append(spec[:, start:end])
            a_start, a_end = start * self.hop_samples, end * self.hop_samples
            audio = record["audio"][:, a_start:a_end]
            pad = (a_end - a_start) - audio.shape[-1]
            if pad > 0:
                audio = np.pad(audio, ((0, 0), (0, pad)))
            audios.append(audio)
            indices.append(record["index"])
        if not audios:
            raise ValueError("all records in batch shorter than crop_mel_frames")
        return np.stack(audios), np.stack(specs), np.asarray(indices, dtype=np.int64)


class WaveGradDataLoader(BaseDataLoader):
    """Vocoder-path loader: shuffled, drop_last, hop-aligned random crops."""

    def __init__(self, dataset, batch_size, hop_samples, crop_mel_frames, num_workers=1):
        super().__init__(dataset, batch_size, shuffle=True, validation_split=0.0,
                         num_workers=num_workers,
                         collate_fn=_WaveGradCollator(hop_samples, crop_mel_frames),
                         drop_last=True)


DATASETS = {
    "AudioDataset": AudioDataset,
    "InferDataset": InferDataset,
    "OutputDataset": OutputDataset,
    "NumpyDataset": NumpyDataset,
}

DATA_LOADERS = {
    "AudioDataLoader": AudioDataLoader,
    "InferDataLoader": InferDataLoader,
    "WaveGradDataLoader": WaveGradDataLoader,
}
