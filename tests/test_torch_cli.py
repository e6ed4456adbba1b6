"""``sddm_tpu_torch.cli.build_network`` against the JAX package's
``sddm_tpu/cli.py::build_network``: config args the module does not take are
dropped (the JAX package filters them against the module's fields), and
``"packed": true`` is refused where the packed engine cannot serve: a
UNetModified2 with dropout (inference only, as in JAX) and, on a card, a
DiffWave whose residual channel count the stack kernel is not built for."""

import pytest

from sddm_tpu.cli import build_network as jax_build_network
from sddm_tpu_torch.cli import build_network
from sddm_tpu_torch.models import DiffWave, FusedDiffWave, UNetModified2

UNET = {"num_samples": 72,
        "network": {"type": "UNetModified2",
                    "args": {"inner_channel": 8, "norm_groups": 4, "channel_mults": [1, 2],
                             "res_blocks": 1, "segment_len": 16, "segment_stride": 8}}}


def _with(base, packed=None, **args):
    cfg = {**base, "network": {**base["network"], "args": {**base["network"]["args"], **args}}}
    if packed is not None:
        cfg["packed"] = packed
    return cfg


def test_extra_config_args_are_dropped_as_in_jax():
    cfg = _with(UNET, unknown_key=3, num_samples_hint=5)
    net = build_network(cfg, num_samples=72)
    assert type(net) is UNetModified2 and net.inner_channel == 8
    assert jax_build_network(cfg, num_samples=72).inner_channel == 8
    dw = build_network({"network": {"type": "DiffWave",
                                    "args": {"residual_channels": 32, "residual_layers": 2,
                                             "extra": True}}})
    assert type(dw) is DiffWave and dw.residual_channels == 32


def test_packed_unet_with_dropout_is_refused_as_in_jax():
    cfg = _with(UNET, packed=True, dropout=0.1)
    with pytest.raises(ValueError, match="dropout"):
        build_network(cfg, num_samples=72)
    with pytest.raises(ValueError, match="dropout"):
        jax_build_network(cfg, num_samples=72)
    assert build_network(_with(UNET, packed=True, dropout=0), num_samples=72).dropout == 0


@pytest.mark.parametrize("channels,ok", [(16, False), (32, True), (64, True), (128, False)])
def test_packed_diffwave_takes_the_kernels_channel_counts(channels, ok):
    cfg = {"packed": True, "network": {"type": "DiffWave",
                                       "args": {"residual_channels": channels,
                                                "residual_layers": 2}}}
    if ok:
        assert isinstance(build_network(cfg, device="cuda"), FusedDiffWave)
    else:
        with pytest.raises(ValueError, match=r"residual_channels in \(32, 64\)"):
            build_network(cfg, device="cuda")
        assert type(build_network({**cfg, "packed": False}, device="cuda")) is DiffWave
    # off the card the fused engine runs the plain stack, which takes any count
    assert isinstance(build_network(cfg, device="cpu"), FusedDiffWave)
    assert isinstance(build_network(cfg), FusedDiffWave)
