"""The DiffWave residual stack of the PyTorch port
(``sddm_tpu_torch.ops.diffwave_stack``) against the JAX package: its plain
version against the JAX ``diffwave_stack_reference`` and against the Pallas
kernel in interpret mode, on the same seeded numpy inputs.

Tolerances: float32 2e-5 absolute and relative, as the JAX package holds its
own kernel to its reference (tests/test_diffwave_fused.py): the products are
summed in another order.  bfloat16: both sides round x, the gate and the skip
sum at the same points, so they differ only where an f32 sum that differs in
its last bits rounds to the neighbouring bf16 value; such a flip moves a
value by one bf16 ulp and the later layers carry it.  The bf16 case is held
to 4 ulps (2**-6 relative to the output's scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sddm_tpu.ops.pallas.diffwave_stack import diffwave_stack as jax_kernel
from sddm_tpu.ops.pallas.diffwave_stack import diffwave_stack_reference as jax_reference
from sddm_tpu_torch.ops.diffwave_stack import (
    _check,
    diffwave_stack,
    diffwave_stack_reference,
)


def _inputs(B, T, C, L, seed):
    rng = np.random.default_rng(seed)
    shapes = [(B, T, C), (L, B, T, 2 * C), (L, B, C), (L, 3, C, 2 * C), (L, C, 2 * C),
              (L, 1, 2 * C)]
    return [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _port(args, cycle, dtype=torch.float32):
    out = diffwave_stack_reference(*(torch.from_numpy(a).to(dtype) for a in args), cycle=cycle)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("cycle,L,T", [(3, 5, 512), (3, 7, 512), (5, 7, 512), (4, 12, 512),
                                       (10, 11, 512), (3, 7, 500), (6, 4, 40)])
def test_reference_matches_jax_reference(cycle, L, T):
    # T=500 is not a multiple of the JAX kernel's 128; at T=40 the dilations
    # 16 and 32 (L < cycle) reach past the whole signal
    args = _inputs(2, T, 8, L, seed=cycle * 100 + L + T)
    want = np.asarray(jax_reference(*map(jnp.asarray, args), cycle=cycle))
    np.testing.assert_allclose(_port(args, cycle), want, rtol=2e-5, atol=2e-5)


def test_reference_matches_jax_kernel_interpret():
    # the one case tests/test_diffwave_fused.py keeps in the fast tier
    args = _inputs(2, 128, 8, 7, seed=7)
    want = np.asarray(jax_kernel(*map(jnp.asarray, args), cycle=5, interpret=True))
    np.testing.assert_allclose(_port(args, 5), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cycle,L", [(3, 7), (10, 12)])
def test_bf16_matches_jax_reference(cycle, L):
    args = _inputs(2, 512, 8, L, seed=L)
    want = np.asarray(jax_reference(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                                    cycle=cycle).astype(jnp.float32))
    got = _port(args, cycle, torch.bfloat16)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0**-8 * scale)


def test_wrapper_runs_the_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(2, 96, 8, 5, seed=3)]
    before = (diffwave_stack.launches, diffwave_stack.layer_launches)
    got = diffwave_stack(*args, cycle=3)
    assert torch.equal(got, diffwave_stack_reference(*args, cycle=3))
    assert (diffwave_stack.launches, diffwave_stack.layer_launches) == before


def test_check_refuses_what_the_kernel_does_not_take():
    good = [torch.from_numpy(a) for a in _inputs(2, 40, 64, 3, seed=1)]
    _check(*good, 3)
    bad_cases = [
        (0, good[0][..., :16].contiguous(), r"C in \(32, 64\)"),    # channels
        (1, good[1][:, :, :20].contiguous(), "cond must be"),        # shape
        (3, good[3].to(torch.float64), "wconv is"),                  # dtype
        (4, good[4].transpose(1, 2).contiguous().transpose(1, 2), "contiguous"),
        (0, good[0][..., :48].contiguous(), r"C in \(32, 64\)"),
        (0, torch.zeros(2, 40, 128), r"C in \(32, 64\)"),
        (0, torch.empty(65536, 16, 64, device="meta"), "bad stack shape"),  # grid's B limit
    ]
    # TMA reads from 16-byte aligned addresses: a contiguous view one element
    # into its storage is refused
    for i, t in enumerate(good):
        view = torch.zeros(t.numel() + 4)[1:t.numel() + 1].view(t.shape)
        assert view.is_contiguous() and view.data_ptr() % 16
        bad_cases.append((i, view, "contiguous and 16-byte aligned"))
    for i, tensor, match in bad_cases:
        args = list(good)
        args[i] = tensor
        with pytest.raises((ValueError, TypeError), match=match):
            _check(*args, 3)
    with pytest.raises(ValueError, match="cycle"):
        _check(*good, 31)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check(*(t.double() for t in good), 3)


def _meta(B, T, C=64, L=1, dtype=torch.bfloat16):
    # shapes past the kernel's limits, without memory
    shapes = [(B, T, C), (L, B, T, 2 * C), (L, B, C), (L, 3, C, 2 * C), (L, C, 2 * C),
              (L, 1, 2 * C)]
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("B,T,match", [
    (1, 2**30, r"T < 2\*\*30"),          # a TMA coordinate t - d must fit in 32 bits
    (8, 2**29, r"B\*T < 2\*\*32"),       # cond's outer TMA stride below 2**40 bytes
])
def test_check_refuses_shapes_past_the_persistent_grid(B, T, match):
    with pytest.raises(ValueError, match=match):
        _check(*_meta(B, T), 3)


@pytest.mark.parametrize("B,T", [(1, 2**30 - 1), (4, 2**30 - 1), (65535, 64)])
def test_check_takes_shapes_at_the_limits(B, T):
    _check(*_meta(B, T), 3)
