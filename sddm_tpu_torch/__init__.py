"""PyTorch + CUDA port of ``sddm_tpu`` for NVIDIA Hopper (H100).

Imports torch and numpy only; nothing of JAX, flax, msgpack or ``sddm_tpu``.
Module names mirror ``sddm_tpu``'s so each counterpart is easy to find.
Entry points: ``load_enhancer`` (SDDM + UNetModified2 speech enhancement,
served by default through the packed engine ``PackedUNetModified2``),
``load_specmodel`` (SDDM_spectrogram + DiffWave vocoding), and the
command lines ``python -m sddm_tpu_torch.infer``, ``.evaluate_results`` and
``.make_synthetic_corpus``, counterparts of the root scripts.
"""

from .enhance import Enhancer, load_enhancer, load_unet_weights
from .models.unet_packed import PackedUNetModified2
from .specmodel import load_specmodel

__all__ = ["Enhancer", "PackedUNetModified2", "load_enhancer", "load_specmodel",
           "load_unet_weights"]
