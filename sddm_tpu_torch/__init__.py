"""PyTorch + CUDA port of ``sddm_tpu`` for NVIDIA Hopper (H100).

Imports torch and numpy only; nothing of JAX, flax, msgpack or ``sddm_tpu``.
Module names mirror ``sddm_tpu``'s so each counterpart is easy to find.
"""

from .enhance import Enhancer, load_enhancer

__all__ = ["Enhancer", "load_enhancer"]
