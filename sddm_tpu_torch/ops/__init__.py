"""Tensor ops of the port: framing (``framing``), spectrogram features
(``spectrogram``), log-modulus companding (``logaudio``), the space-to-depth
kernel packing (``packed``), the hand-written CUDA kernels with their plain
versions (``gn_silu`` in NCHW and NHWC, ``diffwave_stack``), built by
``cuda_build``, and the host scorers ``stoi`` and ``pesq_approx``."""
