"""Tensor ops of the port: framing (``framing``), spectrogram features
(``spectrogram``), and the hand-written CUDA kernels with their plain
versions (``gn_silu``, ``diffwave_stack``), built by ``cuda_build``."""
