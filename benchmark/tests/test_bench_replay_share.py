"""The readers ``denoiser_replay_share`` and ``denoiser_replay_share.host_paced``
on span trees made by hand: 0 where no ``sampler.step`` holds a
``denoiser.replay`` (a program without the packed denoiser's CUDA graph),
100 where every step holds one, the share in between, nothing without a
recorder or with spans dropped.  The test marked ``chip`` traces a tiny
packed sampler call on the card, CPU activity on, and checks that each
``sampler.step`` launches the denoiser's graph once and holds one
``denoiser.replay``:

    python -m pytest benchmark/tests/test_bench_replay_share.py -m chip -s
"""

from __future__ import annotations

import time

import pytest

from benchmark.layer_metrics import _program_spans
from benchmark.tests.test_bench_program_spans import EVENTS, _recorder, _span, reader

NAMES = ["denoiser_replay_share", "denoiser_replay_share.host_paced"]


def _call(rec, t0=0, replays=()):
    """One enhance call, times in ns from ``t0``, as the span tests' own:
    its two ``sampler.step`` spans (200-400 and 400-600) numbered 0 and 1,
    those in ``replays`` holding a ``denoiser.replay`` 20 ns from their start."""
    call = _span(rec, "enhance.call", t0, t0 + 1000, samples_in=300, samples_sampled=400)
    _span(rec, "enhance.chunk", t0, t0 + 100, call)
    _span(rec, "enhance.to_device", t0 + 100, t0 + 150, call)
    sampler = _span(rec, "sampler.call", t0 + 150, t0 + 600, call)
    _span(rec, "sampler.prepare", t0 + 150, t0 + 200, sampler)
    for i, (start, t) in enumerate(((200, 2), (400, 1))):
        step = _span(rec, "sampler.step", t0 + start, t0 + start + 200, sampler, t=t)
        if i in replays:
            _span(rec, "denoiser.replay", t0 + start, t0 + start + 20, step)
    _span(rec, "enhance.wait", t0 + 600, t0 + 800, call)
    _span(rec, "enhance.to_host", t0 + 800, t0 + 850, call)
    _span(rec, "enhance.chunk", t0 + 850, t0 + 1000, call)


@pytest.mark.parametrize("name", NAMES)
def test_replay_share_on_spans_made_by_hand(monkeypatch, name):
    read = reader(name)
    ctx = {"kind": "enhance", "calls": 2, "events": EVENTS, "window_s": 2000e-9}
    rec = _recorder(monkeypatch)
    _call(rec, t0=-5000, replays=(0, 1))  # before the window's calls
    _call(rec)
    _call(rec, t0=1000)
    assert read(ctx) == 0.0
    rec = _recorder(monkeypatch)
    _call(rec, replays=(0, 1))
    _call(rec, t0=1000, replays=(0, 1))
    assert read(ctx) == pytest.approx(100.0)
    rec = _recorder(monkeypatch)
    _call(rec, replays=(1,))
    _call(rec, t0=1000, replays=(0, 1))
    assert read(ctx) == pytest.approx(75.0)
    rec.dropped = 1
    assert read(ctx) is None
    monkeypatch.setattr(_program_spans, "recorder", lambda: None)
    assert read(ctx) is None
    assert read(dict(ctx, kind="train", steps=2)) is None


@pytest.mark.chip
def test_each_step_launches_the_denoisers_graph_once(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sddm_tpu_torch.models.unet_packed import PackedUNetModified2
    from sddm_tpu_torch.parallel.dryrun import tiny_flagship
    from sddm_tpu_torch.train.trainer import init_parameters
    from sddm_tpu_torch.utils import profiling

    model = tiny_flagship(6)
    init_parameters(model.network, torch.Generator().manual_seed(0))
    model.network = PackedUNetModified2(model.network.to(card).eval()).eval()
    cond = 0.1 * torch.randn((16, 1, 72), device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    model.infer(cond, gen)  # builds, first launches and the forward's capture
    torch.cuda.synchronize()
    mark = profiling.mark()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(5):
            model.infer(cond, gen)
        torch.cuda.synchronize()
        time.sleep(0.05)
    spans = profiling.spans(mark)
    events = list(prof.profiler.kineto_results.events())
    graphs = [e for e in events if e.name().startswith("cudaGraphLaunch")]
    steps = [s for s in spans if s.name == "sampler.step"]
    assert len(steps) == 30
    per_step = [sum(s.start_ns <= e.start_ns() <= s.end_ns for e in graphs) for s in steps]
    assert per_step == [1] * len(steps), per_step
    replays = [sum(r.parent == s.id for r in spans if r.name == "denoiser.replay")
               for s in steps]
    assert replays == [1] * len(steps), replays
    launched = {e.correlation_id() for e in graphs}
    kernels = [e for e in events if e.device_type().name == "CUDA" and e.duration_ns() > 0
               and e.correlation_id() in launched]
    assert {k.correlation_id() for k in kernels} == launched
    print(f"{len(graphs)} graph launches, {len(kernels)} of their kernels on the device")
