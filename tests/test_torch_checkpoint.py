"""The PyTorch port's msgpack checkpoint reader and the flagship forward
with the committed trained weights, against the JAX package.

The reader must return exactly the arrays flax's own ``msgpack_restore``
returns.  The flagship forward (one 16448-sample row, float32 on the CPU)
runs 33 GroupNorms deep with convolution sums in other orders; it is held
to 1e-3 absolute and relative on a predicted noise of unit scale.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sddm_tpu.models import UNetModified2 as JaxUNet
from sddm_tpu_torch.compat import state_dict_from_jax
from sddm_tpu_torch.models import UNetModified2
from sddm_tpu_torch.train.checkpoints import load_checkpoint, msgpack_restore

RUN = Path(__file__).resolve().parent.parent / "artifacts" / "flagship_synth"
CKPT = RUN / "model_best.ckpt"
N_PARAMS = 5_229_793


def _assert_same_tree(a, b, path="root"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.fixture(scope="module")
def ckpt_bytes():
    return CKPT.read_bytes()


def test_reader_matches_flax_msgpack_restore(ckpt_bytes):
    _assert_same_tree(msgpack_restore(ckpt_bytes), serialization.msgpack_restore(ckpt_bytes))


def test_reader_round_trips_flax_types():
    doc = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": np.float32(1.5),
           "c": {"d": [1, -3, 2**40, -(2**40), 0.25, None, True, "x" * 40]},
           "e": np.zeros((0, 4), np.float64), "f": b"\x00\x01" * 200}
    data = serialization.msgpack_serialize(doc)
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])


def test_load_checkpoint_flagship():
    ckpt = load_checkpoint(CKPT)
    assert "opt_state" not in ckpt and ckpt["arch"] == "SDDM" and ckpt["epoch"] == 250
    leaves = jax.tree_util.tree_leaves(ckpt["params"])
    assert sum(x.size for x in leaves) == N_PARAMS
    assert all(x.dtype == np.float32 for x in leaves)
    assert "opt_state" in load_checkpoint(CKPT, with_opt_state=True)


def test_flagship_forward_with_trained_weights_matches_jax():
    config = json.loads((RUN / "config.json").read_text())
    args = {k: v for k, v in config["network"]["args"].items() if k != "dropout"}
    params = load_checkpoint(CKPT)["params"]
    n = config["num_samples"]
    rng = np.random.default_rng(0)
    cond = (0.1 * rng.standard_normal((1, 1, n))).astype(np.float32)
    x_t = (0.8 * cond + 0.3 * rng.standard_normal((1, 1, n))).astype(np.float32)
    level = np.full((1, 1, 1), 0.95, np.float32)

    jnet = JaxUNet(num_samples=n, **args)
    want = np.asarray(jax.jit(jnet.apply)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(cond), jnp.asarray(x_t), jnp.asarray(level)))

    tnet = UNetModified2(num_samples=n, **args).eval()
    tnet.load_state_dict(state_dict_from_jax(params, args["channel_mults"],
                                             args["res_blocks"], args["inner_channel"]))
    with torch.no_grad():
        got = tnet(torch.from_numpy(cond), torch.from_numpy(x_t),
                   torch.from_numpy(level)).numpy()
    assert got.shape == want.shape == (1, 1, n)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
