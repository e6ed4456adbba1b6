"""The port's own spans (``sddm_tpu_torch.utils.profiling``) on the CPU:
off, a served call records nothing and reads no clock; under
``recording()`` or a CPU profiler window, one ``enhance.call`` holds its
blocks' ``sampler.call`` and each step's ``sampler.step`` under one root;
the warm-up thread keeps its own parents; the train step's three phases;
the spans among ``profile_dir``'s ``trace.json`` events; the spans on the
profiler's clock; the spans dropped beyond the recorder's limit."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sddm_tpu_torch.diffusion.schedule import DiffusionSchedule
from sddm_tpu_torch.enhance import Enhancer
from sddm_tpu_torch.models.losses import l1_loss
from sddm_tpu_torch.models.sddm import SDDM_spectrogram, SDDM_with_SNREstimator
from sddm_tpu_torch.models.snr_estimator import SNREstimator
from sddm_tpu_torch.models.unet_variable import UNetModified2_VariableNoiseLevel
from sddm_tpu_torch.ops.framing import Segmentor
from sddm_tpu_torch.models.unet_packed import PackedUNetModified2
from sddm_tpu_torch.parallel.dryrun import AMSGRAD, TINY, global_draws, tiny_flagship
from sddm_tpu_torch.train.state import make_optimizer
from sddm_tpu_torch.train.trainer import Trainer, init_parameters, make_train_step
from sddm_tpu_torch.utils import ConfigParser, profiling

NS = TINY["num_samples"]
STEPS = 2
ROWS = 4
# 2 + 3 + 1 rows of 72 samples: two blocks of 4 rows, the second with 2 padding rows
LENGTHS = (100, 200, 60)


@pytest.fixture(scope="module")
def enhancer():
    model = tiny_flagship(STEPS)
    init_parameters(model.network, torch.Generator().manual_seed(0))
    model.network = PackedUNetModified2(model.network.eval()).eval()
    return Enhancer(model, NS, ROWS)


def _audios():
    rng = np.random.default_rng(0)
    return [0.1 * rng.standard_normal(n).astype(np.float32) for n in LENGTHS]


class _NoClock:
    """A ``time`` module whose clocks raise: nothing may read them."""

    def __getattr__(self, name):
        raise AssertionError(f"the recorder read time.{name} with nothing recording")


def test_off_a_served_call_records_nothing_and_reads_no_clock(enhancer, monkeypatch):
    assert profiling.span("enhance.call") is profiling.NO_SPAN
    assert profiling.span("x", device=True, t=3) is profiling.NO_SPAN
    with profiling.NO_SPAN as s:
        assert s is None
    mark = profiling.mark()
    monkeypatch.setattr(profiling, "time", _NoClock())
    outs = enhancer.enhance_batch(_audios())
    monkeypatch.undo()
    assert [o.size for o in outs] == list(LENGTHS)
    assert profiling.spans(mark) == []


def _served_spans(enhancer, how: str) -> list:
    if how == "recording":
        with profiling.recording() as spans:
            enhancer.enhance_batch(_audios())
        return spans
    mark = profiling.mark()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("x") is not profiling.NO_SPAN
        enhancer.enhance_batch(_audios())
    assert profiling.span("x") is profiling.NO_SPAN
    return profiling.spans(mark)


@pytest.mark.parametrize("how", ["recording", "profiler_window"])
def test_a_served_call_is_one_tree(enhancer, how):
    spans = _served_spans(enhancer, how)
    by_id = {s.id: s for s in spans}
    calls = [s for s in spans if s.name == "enhance.call"]
    assert len(calls) == 1
    call = calls[0]
    assert call.parent is None and call.root == call.id
    assert all(s.root == call.id for s in spans)
    assert call.attrs == {"rows": 6, "padding_rows": 2, "samples_in": sum(LENGTHS),
                          "samples_sampled": 8 * NS}
    names = sorted(s.name for s in spans if s.parent == call.id)
    assert names == sorted(["enhance.chunk"] * 2 + ["enhance.to_device", "sampler.call",
                                                    "enhance.wait", "enhance.to_host"] * 2)
    samplers = [s for s in spans if s.name == "sampler.call"]
    for sampler in samplers:
        children = sorted((s for s in spans if s.parent == sampler.id), key=lambda s: s.start_ns)
        assert [s.name for s in children] == ["sampler.prepare"] + ["sampler.step"] * STEPS
        assert [s.attrs for s in children[1:]] == [{"t": t} for t in range(STEPS, 0, -1)]
        assert all(sampler.start_ns <= c.start_ns <= c.end_ns <= sampler.end_ns
                   for c in children)
    for s in spans:  # each span inside its parent, on this thread
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and p.thread == s.thread
    assert all(s.device_ms is None for s in spans)


def test_the_warmup_thread_keeps_its_own_parents(enhancer):
    with profiling.recording() as spans:
        with profiling.span("outer") as outer:
            enhancer.warmup(timeout_s=120.0)
    call = [s for s in spans if s.name == "sampler.call"]
    assert len(call) == 1
    call = call[0]
    assert call.parent is None and call.root == call.id and call.thread != outer.thread
    steps = [s for s in spans if s.name == "sampler.step"]
    assert len(steps) == STEPS and all(s.parent == call.id and s.root == call.id for s in steps)
    assert outer.parent is None


def test_spectrogram_sampler_featurizes_inside_one_call():
    """``SDDM_spectrogram`` featurizes inside its one ``sampler.call``."""

    class Zero(torch.nn.Module):
        def forward(self, condition, x, level):
            return torch.zeros_like(x)

    featurized = []

    def feature_fn(audio):
        featurized.append(profiling.RECORDER._stack()[-1].name)
        return audio[:, :, ::4].repeat(1, 3, 1)

    model = SDDM_spectrogram(DiffusionSchedule.create("linear", 3, 1e-4, 0.02), Zero(),
                             hop_samples=4, feature_fn=feature_fn)
    with profiling.recording() as spans:
        out = model.infer(torch.zeros(2, 1, 32), torch.Generator().manual_seed(0))
    assert out.shape == (2, 1, 32) and featurized == ["sampler.call"]
    assert [s.name for s in spans].count("sampler.call") == 1
    assert [s.name for s in spans].count("sampler.step") == 3


def test_snr_sampler_is_one_call_of_its_steps():
    """``SDDM_with_SNREstimator.infer``: one ``sampler.call``, its
    ``sampler.prepare`` (framing, the estimator's tables, x_T) and a
    ``sampler.step`` for each reverse step."""
    torch.manual_seed(0)
    net = UNetModified2_VariableNoiseLevel(inner_channel=8, norm_groups=4, channel_mults=[1, 2],
                                           res_blocks=1, noise_level_channel=16, dropout=0)
    est = SNREstimator(12, 32, inner_channel=8, norm_groups=4, channel_mults=[1, 2],
                       res_blocks=1, dropout=0)
    model = SDDM_with_SNREstimator(3, net.eval(), est.eval(), Segmentor(208, 32, 16),
                                   p_transition="condition_in")
    with torch.no_grad(), profiling.recording() as spans:
        out = model.infer(0.1 * torch.randn(2, 1, 208), torch.Generator().manual_seed(0))
    assert out.shape == (2, 1, 208)
    (call,) = [s for s in spans if s.name == "sampler.call"]
    children = sorted((s for s in spans if s.parent == call.id), key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["sampler.prepare"] + ["sampler.step"] * 3
    assert [s.attrs for s in children[1:]] == [{"t": t} for t in (3, 2, 1)]
    assert all(s.root == call.id for s in spans)


def _tiny_step():
    model = tiny_flagship()
    init_parameters(model.network, torch.Generator().manual_seed(0))
    model.network.train()
    return make_train_step(model, l1_loss, make_optimizer(AMSGRAD, model.network.parameters()))


def _batch(rows=2):
    gen = torch.Generator().manual_seed(1)
    target = 0.1 * torch.randn((rows, 1, NS), generator=gen)
    return target, target + 0.02 * torch.randn((rows, 1, NS), generator=gen)


def test_the_train_steps_three_phases():
    step = _tiny_step()
    target, condition = _batch()
    draws = global_draws(2, (2, 1, NS), 5)
    with profiling.recording() as spans:
        loss = step(target, condition, draws=draws)
    assert torch.isfinite(loss)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["train.step"]
    phases = sorted((s for s in spans if s.parent == roots[0].id), key=lambda s: s.start_ns)
    assert [s.name for s in phases] == ["train.forward", "train.backward", "train.optimizer"]
    assert all(s.device_ms is None for s in phases)  # no card: no CUDA events


def test_backward_ops_lie_inside_their_span_on_the_profilers_clock():
    """Each operation the backward ran (the autograd engine's nodes and the
    ``aten::`` ops inside them, as the profiler stamps them) lies inside the
    ``train.backward`` span to 0.2 ms, and none inside the forward's."""
    step = _tiny_step()
    target, condition = _batch()
    draws = global_draws(2, (2, 1, NS), 5)
    step(target, condition, draws=draws)  # the first step's lazy set-up outside the window
    mark = profiling.mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(target, condition, draws=draws)
    spans = {s.name: s for s in profiling.spans(mark)}
    bwd, fwd = spans["train.backward"], spans["train.forward"]
    events = list(prof.profiler.kineto_results.events())
    nodes = [(e.start_ns(), e.end_ns()) for e in events
             if e.name().startswith("autograd::engine::evaluate_function")]
    assert nodes
    ops = [(e.start_ns(), e.end_ns()) for e in events if e.name().startswith("aten::")
           and any(a <= e.start_ns() and e.end_ns() <= b for a, b in nodes)]
    assert ops
    slack = 200_000  # 0.2 ms
    for start, end in nodes + ops:
        assert bwd.start_ns - slack <= start and end <= bwd.end_ns + slack, (
            (start - bwd.start_ns) / 1e6, (end - bwd.end_ns) / 1e6)
        assert not (fwd.start_ns + slack <= start and end <= fwd.end_ns - slack)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    model = tiny_flagship()
    network = model.network
    config = ConfigParser({
        "name": "traced", "arch": {"type": "SDDM"}, "optimizer": AMSGRAD,
        "trainer": {"epochs": 1, "save_dir": str(tmp_path / "saved"), "save_period": 1,
                    "verbosity": 1, "monitor": "off", "tensorboard": False,
                    "profile_dir": str(tmp_path / "prof"), "log_step": 100}}, run_id="t")
    rng = np.random.default_rng(0)
    batches = [((0.1 * 32768 * rng.standard_normal((2, 1, NS))).astype(np.int16),
                (0.1 * 32768 * rng.standard_normal((2, 1, NS))).astype(np.int16),
                np.arange(2)) for _ in range(5)]
    trainer = Trainer(model, l1_loss, [], make_optimizer(AMSGRAD, network.parameters()), config,
                      batches)
    trainer._train_epoch(1)
    prof_dir = tmp_path / "prof"
    assert [f.name for f in prof_dir.iterdir()] == ["trace.json"]
    trace = json.loads((prof_dir / "trace.json").read_text())
    events = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    names = [e["name"] for e in events]
    # the window covers steps 2-4, the fetches of batches 3 and 4 and of the loader's end
    assert names.count("train.step") == 3 and names.count("train.backward") == 3
    assert names.count("train.data") == 3
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert not any("device_ms" in e["args"] for e in events)  # no card: no CUDA events
    # the spans lie on the trace's time line: the profiled ops start inside the steps
    ops = [e["ts"] for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "train.step"]
    inside = [sum(a <= t <= b for t in ops) for a, b in steps]
    assert min(inside) > 0 and sum(inside) >= 0.9 * len(ops), (inside, len(ops))


def test_spans_beyond_the_limit_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    rec = profiling.Recorder()
    with rec.recording() as spans:
        for k in range(3):
            with rec.span("s", k=k):
                pass
    assert [s.attrs["k"] for s in spans] == [1, 2]
    assert rec.dropped == 1
    events = profiling.chrome_events(spans, base_ns=spans[0].start_ns)
    assert events[0]["ts"] == 0.0 and events[0]["args"]["k"] == 1
    assert {e["ph"] for e in events} == {"X"}
