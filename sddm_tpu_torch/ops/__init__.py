"""Tensor ops of the port: framing (``framing``) and the fused GroupNorm+SiLU
kernel with its plain version (``gn_silu``)."""
