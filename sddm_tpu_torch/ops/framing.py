"""Signal framing and overlap-add (counterpart of ``sddm_tpu/ops/framing.py``).

``frame_signal`` cuts ``[..., n_samples]`` into ``[..., n_frames, frame_len]``
windows at a fixed stride; ``overlap_add`` sums such windows back into a
signal without normalisation, as the reference ``SignalToFrames`` does.
"""

from __future__ import annotations

import torch


def _check_geometry(n_samples: int, frame_len: int, stride: int) -> int:
    if (n_samples - frame_len) % stride != 0:
        raise ValueError(
            f"(n_samples - frame_len) must be divisible by stride; got "
            f"n_samples={n_samples}, frame_len={frame_len}, stride={stride}"
        )
    return (n_samples - frame_len) // stride + 1


def frame_signal(sig: torch.Tensor, frame_len: int, stride: int) -> torch.Tensor:
    """Frame ``[..., n_samples]`` into ``[..., n_frames, frame_len]`` (a view)."""
    _check_geometry(sig.shape[-1], frame_len, stride)
    return sig.unfold(-1, frame_len, stride)


def overlap_add(frames: torch.Tensor, n_samples: int, stride: int) -> torch.Tensor:
    """Inverse of :func:`frame_signal`: ``[..., n_frames, F] -> [..., n_samples]``,
    overlapping regions summed.  Needs ``F % stride == 0`` (every shipped
    config: F=128, stride 64): the ``F / stride`` sub-panes of each frame
    are added into ``[n_frames + k - 1, stride]`` panes in the JAX order."""
    n_frames, frame_len = frames.shape[-2:]
    expect = _check_geometry(n_samples, frame_len, stride)
    if expect != n_frames:
        raise ValueError(f"expected {expect} frames, got {n_frames}")
    if frame_len % stride != 0:
        raise ValueError(f"frame_len {frame_len} is not a multiple of stride {stride}")
    k = frame_len // stride
    sub = frames.reshape(frames.shape[:-1] + (k, stride))
    out = frames.new_zeros(frames.shape[:-2] + (n_frames + k - 1, stride))
    for j in range(k):
        out[..., j : j + n_frames, :] += sub[..., j, :]
    return out.reshape(frames.shape[:-2] + (n_samples,))
