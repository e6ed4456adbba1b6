"""Framing and overlap-add of the PyTorch port against the JAX package: the
same reshapes and adds in the same order, so results are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.ops import framing as jfr
from sddm_tpu_torch.ops import framing as tfr


@pytest.mark.parametrize("n,frame_len,stride", [
    (16448, 128, 64), (208, 32, 16), (72, 16, 8), (22, 6, 4),
])
def test_frame_signal(n, frame_len, stride):
    sig = np.random.default_rng(n).standard_normal((2, 1, n)).astype(np.float32)
    got = tfr.frame_signal(torch.from_numpy(sig), frame_len, stride)
    want = jfr.frame_signal(jnp.asarray(sig), frame_len, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,frame_len,stride", [(16448, 128, 64), (208, 32, 16), (72, 16, 8)])
def test_overlap_add(n, frame_len, stride):
    n_frames = (n - frame_len) // stride + 1
    frames = np.random.default_rng(n).standard_normal(
        (2, 1, n_frames, frame_len)).astype(np.float32)
    got = tfr.overlap_add(torch.from_numpy(frames), n, stride)
    want = jfr.overlap_add(jnp.asarray(frames), n, stride)
    assert got.shape == (2, 1, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bad_geometry_raises():
    with pytest.raises(ValueError):
        tfr.frame_signal(torch.zeros(1, 100), 128, 64)
    with pytest.raises(ValueError):
        tfr.overlap_add(torch.zeros(1, 3, 128), 300, 64)
    with pytest.raises(ValueError):  # frame length not a multiple of stride
        tfr.overlap_add(torch.zeros(1, 5, 6), 22, 4)
