"""The plain references against cases worked out by hand, at tiny sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import ROOT, load_file
from benchmark.reference import plain

UNET = load_file(ROOT / "benchmark" / "reference" / "unet-modified2-flagship.py")
DIFFWAVE = load_file(ROOT / "benchmark" / "reference" / "diffwave-base-64x30.py")


def tiny_unet_config(num_samples=264):
    return {"num_samples": num_samples,
            "network": {"args": {"in_channel": 2, "out_channel": 1, "inner_channel": 4,
                                 "norm_groups": 2, "channel_mults": [1, 2], "res_blocks": 1,
                                 "segment_len": 16, "segment_stride": 8}},
            "diffusion": {"args": {"n_timestep": 4, "linear_start": 0.1, "linear_end": 0.4}}}


def zero_params(config):
    return {k: torch.zeros(v.shape) for k, v in UNET.meta_params(config).items()}


def test_linear_tables_by_hand():
    tab = plain.linear_tables(2, 0.1, 0.3)
    np.testing.assert_allclose(tab["betas"], [0.0, 0.1, 0.3])
    np.testing.assert_allclose(tab["alpha_bar"], [1.0, 0.9, 0.9 * 0.7])
    # sigma_2^2 = (1 - ab_1) / (1 - ab_2) * beta_2 = 0.1 / 0.37 * 0.3
    np.testing.assert_allclose(tab["sigma"][2], np.sqrt(0.1 / 0.37 * 0.3))
    np.testing.assert_allclose(tab["sigma"][1], 0.0)


def test_subsampled_steps_by_hand():
    tab, t_map = plain.subsampled(plain.linear_tables(200, 1e-4, 2e-2), 6)
    assert list(t_map) == [0, 33, 67, 100, 133, 167, 200]
    full = plain.linear_tables(200, 1e-4, 2e-2)["alpha_bar"]
    np.testing.assert_allclose(tab["alpha_bar"][1:], full[[33, 67, 100, 133, 167, 200]])


def test_ancestral_and_ddim_steps_by_hand():
    tab = plain.linear_tables(2, 0.1, 0.3)
    x, eps, z = torch.tensor([0.5]), torch.tensor([0.2]), torch.tensor([1.0])
    want = (0.5 - 0.3 / np.sqrt(1 - 0.63) * 0.2) / np.sqrt(0.7) + np.sqrt(0.1 / 0.37 * 0.3)
    assert plain.ancestral_step(tab, x, 2, eps, z).item() == pytest.approx(want, rel=1e-6)
    want1 = (0.5 - 0.1 / np.sqrt(0.1) * 0.2) / np.sqrt(0.9)  # no noise at t = 1
    assert plain.ancestral_step(tab, x, 1, eps, z).item() == pytest.approx(want1, rel=1e-6)
    x0 = (0.5 - np.sqrt(1 - 0.63) * 0.2) / np.sqrt(0.63)
    want2 = np.sqrt(0.9) * x0 + np.sqrt(0.1) * 0.2
    assert plain.ddim_step(tab, x, 2, eps).item() == pytest.approx(want2, rel=1e-6)
    assert plain.ancestral_step(tab, torch.tensor([5.0]), 1, eps, z).item() == 1.0  # clipped


def test_amsgrad_two_steps_by_hand():
    p = {"w": torch.tensor([1.0])}
    opt = plain.AmsGrad(p, lr=0.1)
    opt.step({"w": torch.tensor([2.0])})
    # step 1: mu_hat = g, nu_hat = g^2: p -= lr * g / (|g| + eps)
    assert p["w"].item() == pytest.approx(1.0 - 0.1 * 2.0 / (2.0 + 1e-8), rel=1e-6)
    opt.step({"w": torch.tensor([0.0])})
    mu = 0.9 * 0.2
    nu = 0.999 * 0.004
    mu_hat, nu_hat = mu / (1 - 0.81), nu / (1 - 0.999**2)
    nu_max = max(4.0, nu_hat)  # the running maximum keeps step 1's 4.0
    want = 1.0 - 0.1 - 0.1 * mu_hat / (np.sqrt(nu_max) + 1e-8)
    assert p["w"].item() == pytest.approx(want, rel=1e-5)


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0625, 1.2])
    q = plain.fp8_round(x)
    assert q[0].item() == 448.0 and q[1].item() == 1.0
    assert q[2].item() == 1.0  # 1 + 2^-4 rounds to even at 3 bits
    assert q[3].item() == pytest.approx(1.25)
    assert not plain.Precision().fp8 and plain.Precision().q(x) is x


def test_unet_reference_zero_weights_gives_twice_the_final_bias():
    # every weight zero: the output frames are the final conv's bias, and
    # overlap-add at half the frame length covers inner samples twice
    cfg = tiny_unet_config()
    params = zero_params(cfg)
    params["final_conv.block.3.bias"] = torch.tensor([0.25])
    net = UNET.network(params, cfg)
    z = torch.randn(2, 1, 264)
    out = net(z, z, torch.tensor([0.5, 0.9]))
    assert out.shape == (2, 1, 264)
    torch.testing.assert_close(out[:, 0, 8:-8], torch.full((2, 248), 0.5))
    torch.testing.assert_close(out[:, 0, :8], torch.full((2, 8), 0.25))
    torch.testing.assert_close(out[:, 0, -8:], torch.full((2, 8), 0.25))


def test_unet_reference_sites_and_flops():
    cfg = tiny_unet_config()
    sites = UNET.norm_sites(cfg, 3)
    # 2 per res block: 2 levels down, 1 middle, 2 x 2 up, and the final block's 1
    assert len(sites) == 2 * (2 + 1 + 4) + 1
    assert sites[0] == ((3, 4, 32, 16), 2)
    # the input conv alone: 2 FLOPs a MAC, 3x3 taps, 2 -> 4 channels on 32 x 16, 3 rows
    conv_in = 2 * 9 * 2 * 4 * 32 * 16 * 3
    assert UNET.forward_flops(cfg, 3) > conv_in
    assert UNET.forward_flops(cfg, 3) == 3 * UNET.forward_flops(cfg, 1)
    assert UNET.forward_flops(cfg, 1, backward=True) > 2 * UNET.forward_flops(cfg, 1)


def test_unet_sampler_with_an_untrained_zero_network_is_the_noisy_chain():
    cfg = tiny_unet_config()
    params = zero_params(cfg)  # eps_hat = 0
    cond = torch.rand(1, 1, 264) * 0.1
    xT, steps = torch.randn(1, 1, 264), [torch.randn(1, 1, 264) for _ in range(2)]
    out = UNET.enhance(params, cfg, cond, xT, steps, 2)
    tab, _ = plain.subsampled(plain.linear_tables(4, 0.1, 0.4), 2)
    x = (np.float32(tab["sqrt_alpha_bar"][-1]) * cond
         + np.float32(np.sqrt(1 - np.float32(tab["sqrt_alpha_bar"][-1]) ** 2)) * xT)
    x = (x / np.float32(np.sqrt(tab["alphas"][2])) + np.float32(tab["sigma"][2]) * steps[0]).clamp(-1, 1)
    x = (x / np.float32(np.sqrt(tab["alphas"][1]))).clamp(-1, 1)
    torch.testing.assert_close(out, x)


def test_diffwave_reference_zero_weights_gives_the_output_bias():
    cfg = {"network": {"args": {"residual_channels": 4, "residual_layers": 3,
                                "dilation_cycle_length": 2}},
           "spectrogram": {"stft_bins": 5}}
    a = cfg["network"]["args"]
    shapes = {"input_projection": (4, 1, 1), "skip_projection": (4, 4, 1),
              "output_projection": (1, 4, 1), "diffusion_embedding.projection1": (512, 128),
              "diffusion_embedding.projection2": (512, 512),
              "spectrogram_upsampler.conv1": (1, 1, 3, 32),
              "spectrogram_upsampler.conv2": (1, 1, 3, 32)}
    for i in range(3):
        shapes.update({f"residual_layers.{i}.dilated_conv": (8, 4, 3),
                       f"residual_layers.{i}.diffusion_projection": (4, 512),
                       f"residual_layers.{i}.conditioner_projection": (8, 5, 1),
                       f"residual_layers.{i}.output_residual": (4, 4, 1),
                       f"residual_layers.{i}.output_projection": (4, 4, 1)})
    params = {}
    for name, shape in shapes.items():
        params[name + ".weight"] = torch.zeros(shape)
        params[name + ".bias"] = torch.zeros(shape[1] if "upsampler" in name else shape[0])
    params["spectrogram_upsampler.conv1.bias"] = torch.zeros(1)
    params["spectrogram_upsampler.conv2.bias"] = torch.zeros(1)
    params["output_projection.bias"] = torch.tensor([0.3])
    net = DIFFWAVE.DiffWave(params, a)
    spec = torch.rand(2, 5, 2)
    up = net.upsample(spec, 512)
    assert up.shape == (2, 5, 512) and float(up.abs().max()) == 0.0
    out = net(up, torch.randn(2, 1, 512), torch.tensor([3.0, 7.0]))
    torch.testing.assert_close(out, torch.full((2, 1, 512), 0.3))


def test_diffwave_upsampler_is_256x_in_time():
    cfg = {"network": {"args": {"residual_channels": 64, "residual_layers": 30}},
           "spectrogram": {"stft_bins": 513}}
    per_call, per_step = DIFFWAVE.forward_flops(cfg, 2, 4, 256)
    # the conditioners: 2 FLOPs x 2 rows x 1024 samples x 513 bins x 128 x 30 layers
    assert per_call > 2 * 2 * 1024 * 513 * 128 * 30
    # a step: per layer and sample the dilated conv (3 x 64 -> 128), the two 1x1 (64 -> 64)
    per_layer = 2 * (3 * 64 * 128 + 2 * 64 * 64)
    assert per_step > 2 * 1024 * 30 * per_layer
    assert per_step < 1.2 * 2 * 1024 * 30 * per_layer + 2 * 1024 * 64 * 64 * 4
