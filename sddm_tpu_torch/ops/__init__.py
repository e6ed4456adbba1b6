"""Tensor ops of the port: framing (``framing``), spectrogram features
(``spectrogram``), the space-to-depth kernel packing (``packed``), and the
hand-written CUDA kernels with their plain versions (``gn_silu`` in NCHW and
NHWC, ``diffwave_stack``), built by ``cuda_build``."""
