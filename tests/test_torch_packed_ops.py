"""The port's space-to-depth packing (``sddm_tpu_torch/ops/packed.py``)
against the JAX package's (``sddm_tpu/ops/packed.py``): the host-side numpy
kernel packing functions and ``pack_input_map`` must give the same arrays
bit for bit, and the torch ``s2d``/``d2s`` the same tensors as the jnp
ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.ops import packed as jpk
from sddm_tpu_torch.ops import packed as tpk

PACKERS = ["pack_kernel_s1", "pack_kernel_s1_to_offset", "pack_kernel_s1_from_offset",
            "pack_kernel_s2_unpacked_out", "pack_kernel_s2_packed_out", "pack_kernel_upsample"]
# (kh, kw, Ci, Co): square, Ci > Co, Ci < Co
SHAPES = [(3, 3, 4, 4), (3, 3, 6, 2), (3, 3, 2, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", PACKERS)
def test_kernel_packers_equal_jax_bitwise(name, shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got, want = getattr(tpk, name)(w), getattr(jpk, name)(w)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_one_by_one_s1_equals_jax_bitwise():
    w = np.random.default_rng(5).standard_normal((1, 1, 3, 7)).astype(np.float32)
    np.testing.assert_array_equal(tpk.pack_kernel_s1(w), jpk.pack_kernel_s1(w))


@pytest.mark.parametrize("sections", [(4,), (3, 5), (2, 6, 1)], ids=str)
def test_pack_input_map_equals_jax(sections):
    got, want = tpk.pack_input_map(sections), jpk.pack_input_map(sections)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(4 * sum(sections)))  # a permutation


@pytest.mark.parametrize("h,w,c", [(9, 5, 8), (13, 7, 2), (2, 2, 1)])
def test_offset_mask_equals_jax(h, w, c):
    np.testing.assert_array_equal(tpk.offset_mask(h, w, c), jpk.offset_mask(h, w, c))


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 16, 5)], ids=str)
def test_s2d_d2s_equal_jax_and_are_inverse(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x)
    packed = tpk.s2d(xt)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk.s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(tpk.d2s(packed).numpy(), x)
    np.testing.assert_array_equal(
        tpk.d2s(packed).numpy(), np.asarray(jpk.d2s(jnp.asarray(packed.numpy()))))
