"""Data on the host (counterpart of ``sddm_tpu/data``): the WAV codec,
datasets, loaders and the synthetic corpus generator."""

from .datasets import AudioDataset, InferDataset, NumpyDataset, OutputDataset, generate_inventory
from .loaders import (
    DATA_LOADERS,
    DATASETS,
    AudioDataLoader,
    InferDataLoader,
    WaveGradDataLoader,
)
from .wav_io import load_wav, save_wav

__all__ = [
    "load_wav",
    "save_wav",
    "AudioDataset",
    "InferDataset",
    "NumpyDataset",
    "OutputDataset",
    "generate_inventory",
    "AudioDataLoader",
    "InferDataLoader",
    "WaveGradDataLoader",
    "DATASETS",
    "DATA_LOADERS",
]
