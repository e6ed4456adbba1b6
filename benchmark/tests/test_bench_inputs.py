"""Inputs from the seed: the same seed the same inputs, another seed the same
sizes in another order; the weights' scales; the NumPy features."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, inputs

SEED = 2**31 + 12345  # larger than 32 signed bits hold


def enhance_traffic():
    return harness.cell_of(harness.load_spec(), "enhance-flagship-r256").traffic


def calls(seed, n=40):
    r = inputs.EnhanceRequests(enhance_traffic(), seed, 16448)
    return [r.next_call() for _ in range(n)]


def test_same_seed_same_requests_other_seed_same_sizes():
    a, b = calls(SEED), calls(SEED)
    assert all(len(x) == len(y) and all(np.array_equal(p, q) for (_, p), (_, q) in zip(x, y))
               for x, y in zip(a, b))
    grid = inputs.EnhanceRequests(enhance_traffic(), SEED, 16448).lengths
    other = inputs.EnhanceRequests(enhance_traffic(), SEED + 1, 16448).lengths
    assert np.array_equal(np.sort(grid), np.sort(other))
    assert grid.min() >= 16000 and grid.max() <= 160000
    assert abs(np.median(grid) - 2.5 * 16000) < 0.02 * 16000
    c = calls(SEED + 1)
    assert [len(x) for x in a] != [len(x) for x in c]


def test_calls_fill_their_rows():
    fill = enhance_traffic()["fill_rows"]
    for call in calls(SEED, 30):
        rows = sum(-(-a.size // 16448) for _, a in call)
        assert fill - 9 <= rows <= fill  # a request needs 10 rows at the most


def test_seeded_weights_scales():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(400, 300), torch.nn.GroupNorm(4, 300))
    params = inputs.seeded_weights(net, SEED, "cpu")
    assert float(net[0].weight.detach().std()) == float(params["0.weight"].std())
    assert abs(float(net[0].weight.detach().std()) * 20 - 1) < 0.02
    assert abs(float(net[1].weight.detach().mean()) - 1) < 0.02
    again = inputs.seeded_weights(net, SEED, "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_stft_features_of_a_sine():
    n_fft, hop, frames = 1024, 256, 8
    t = np.arange(frames * hop) / 16000
    audio = (0.5 * np.sin(2 * np.pi * 1000 * t))[None]
    feat = inputs.stft_features(audio, n_fft, hop, frames)
    assert feat.shape == (1, 513, frames)
    assert np.all(np.argmax(feat[0, :, 2:-2], axis=0) == 64)  # 1000 Hz / 15.625 Hz a bin
    assert feat.min() >= 0 and feat.max() <= 1


def test_vocode_and_train_inputs_repeat():
    spec = harness.load_spec()
    tr = dict(harness.cell_of(spec, "vocode-diffwave-b16").traffic, pool=4, frames=4)
    a, b = inputs.VocodeRequests(tr, SEED, "cpu"), inputs.VocodeRequests(tr, SEED, "cpu")
    assert torch.equal(a.specs, b.specs) and torch.equal(a.next_call(), b.next_call())
    tt = dict(harness.cell_of(spec, "train-flagship-b256").traffic, pool_rows=8, batch=4)
    x, y = inputs.TrainBatches(tt, SEED, 264, "cpu"), inputs.TrainBatches(tt, SEED, 264, "cpu")
    assert torch.equal(x.noisy, y.noisy)
    seen = torch.cat([x.next_rows(), x.next_rows()])
    assert sorted(seen.tolist()) == list(range(8))  # a pass takes every row once
