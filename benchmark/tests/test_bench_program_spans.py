"""The readers of the program's own spans (``layer_metrics/_program_spans.py``
and the metrics that use it): on spans and device events made by hand, the
idle attribution included; against a program without the recorder; and on
a tiny enhance and vocode run on the CPU under ``recording()``, where the
program's ``sampler.call`` spans agree call by call with the benchmark's
``infer`` spans.  The test marked ``chip`` checks on the card that the
spans and the profiler's own host events share one clock, and reads the
device's step against it:

    python -m pytest benchmark/tests/test_bench_program_spans.py -m chip -s
"""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.cells import KINDS
from benchmark.layer_metrics import _program_spans
from benchmark.tests.test_bench_faults import SEED, tiny

READERS = ["enhance_self_ms", "enhance_copy_ms", "enhance_wait_ms", "padded_share",
           "sampler_step_host_ms", "sampler_step_host_ms.host_paced",
           "idle_in_sampler_share.serve", "idle_in_sampler_share.serve_host_paced",
           "idle_in_serving_share.serve", "idle_in_serving_share.serve_host_paced",
           "train_forward_device_ms.train", "train_backward_device_ms.train",
           "train_optimizer_device_ms.train"]


def reader(name):
    return harness.load_file(harness.ROOT / "benchmark" / "layer_metrics" / f"{name}.py").read


class _Event:
    """A CUDA event made by hand: ``elapsed_time`` is the difference of ``t``."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _recorder(monkeypatch):
    from sddm_tpu_torch.utils import profiling

    rec = profiling.Recorder()
    monkeypatch.setattr(_program_spans, "recorder", lambda: rec)
    return rec


def _span(rec, name, start, end, parent=None, device_ms=None, **attrs):
    from sddm_tpu_torch.utils.profiling import Span

    s = Span(rec, name, attrs, False)
    s.id = rec.mark()
    s.parent = None if parent is None else parent.id
    s.root = s.id if parent is None else parent.root
    s.start_ns, s.end_ns, s.thread = start, end, 1
    if device_ms is not None:
        s._events = (_Event(0.0), _Event(device_ms))
    rec._keep(s)
    return s


def _enhance_call(rec, t0=0):
    """One call, times in ns from ``t0``: chunk 0-100, to_device 100-150,
    sampler 150-600 (prepare 150-200, steps 200-400 and 400-600), wait
    600-800, to_host 800-850, chunk 850-1000."""
    call = _span(rec, "enhance.call", t0, t0 + 1000, samples_in=300, samples_sampled=400)
    _span(rec, "enhance.chunk", t0, t0 + 100, call)
    _span(rec, "enhance.to_device", t0 + 100, t0 + 150, call)
    sampler = _span(rec, "sampler.call", t0 + 150, t0 + 600, call)
    _span(rec, "sampler.prepare", t0 + 150, t0 + 200, sampler)
    _span(rec, "sampler.step", t0 + 200, t0 + 400, sampler, t=2)
    _span(rec, "sampler.step", t0 + 400, t0 + 600, sampler, t=1)
    _span(rec, "enhance.wait", t0 + 600, t0 + 800, call)
    _span(rec, "enhance.to_host", t0 + 800, t0 + 850, call)
    _span(rec, "enhance.chunk", t0 + 850, t0 + 1000, call)


# busy 0-20, 60-250, 300-580, 620-700, 750-880, 950-1000; the gaps: 20-60 in the
# first chunk, 250-300 in a step, 580-620 half in a step and half in the wait,
# 700-750 in the wait, 880-950 in the last chunk
EVENTS = [("k", 0, 20), ("k", 60, 250), ("k", 300, 580), ("k", 620, 700), ("k", 750, 880),
          ("k", 950, 1000)]


@pytest.mark.parametrize("step_ns", [0, 7_700_000])
def test_serving_readers_on_spans_made_by_hand(monkeypatch, step_ns):
    rec = _recorder(monkeypatch)
    _enhance_call(rec, t0=-5000)  # an earlier call: not the window's
    _enhance_call(rec)
    monkeypatch.setattr(_program_spans, "DEVICE_STEP_NS", step_ns)
    events = [(n, s + step_ns, e + step_ns) for n, s, e in EVENTS]
    ctx = {"kind": "enhance", "calls": 1, "events": events, "window_s": 1000e-9}
    assert reader("enhance_self_ms")(ctx) == pytest.approx(350e-6)
    assert reader("enhance_copy_ms")(ctx) == pytest.approx(100e-6)
    assert reader("enhance_wait_ms")(ctx) == pytest.approx(200e-6)
    assert reader("padded_share")(ctx) == pytest.approx(25.0)
    assert reader("sampler_step_host_ms")(ctx) == pytest.approx(200e-6)
    assert reader("sampler_step_host_ms.host_paced")(ctx) == pytest.approx(200e-6)
    assert reader("idle_in_sampler_share.serve")(ctx) == pytest.approx(7.0)
    assert reader("idle_in_sampler_share.serve_host_paced")(ctx) == pytest.approx(7.0)
    assert reader("idle_in_serving_share.serve")(ctx) == pytest.approx(11.0)
    assert reader("idle_in_serving_share.serve_host_paced")(ctx) == pytest.approx(11.0)
    for name in READERS[-3:]:
        assert reader(name)(ctx) is None
    two = dict(ctx, calls=2)  # both calls: the earlier one is busy-free, so outside the events
    assert reader("enhance_wait_ms")(two) == pytest.approx(200e-6)
    assert reader("enhance_self_ms")(dict(ctx, calls=3)) is None  # fewer calls than the window's


def test_innermost_and_overlap():
    from sddm_tpu_torch.utils import profiling

    rec = profiling.Recorder()
    a = _span(rec, "a", 0, 100)
    b = _span(rec, "b", 10, 40, a)
    _span(rec, "c", 20, 30, b)
    _span(rec, "d", 60, 100, a)
    segs = _program_spans.innermost(rec.spans())
    assert segs == [(0, 10, "a"), (10, 20, "b"), (20, 30, "c"), (30, 40, "b"), (40, 60, "a"),
                    (60, 100, "d")]
    assert _program_spans.overlap_ns([(0, 15), (35, 70)], segs) == 15 + 35


def test_train_phase_readers_on_spans_made_by_hand(monkeypatch):
    rec = _recorder(monkeypatch)
    for k in range(3):
        step = _span(rec, "train.step", 100 * k, 100 * k + 90)
        _span(rec, "train.forward", 100 * k, 100 * k + 30, step, device_ms=40.0 + k)
        _span(rec, "train.backward", 100 * k + 30, 100 * k + 60, step, device_ms=80.0)
        _span(rec, "train.optimizer", 100 * k + 60, 100 * k + 90, step, device_ms=4.0)
    ctx = {"kind": "train", "steps": 2, "events": [], "window_s": 1.0}
    assert reader("train_forward_device_ms.train")(ctx) == pytest.approx(41.5)
    assert reader("train_backward_device_ms.train")(ctx) == pytest.approx(80.0)
    assert reader("train_optimizer_device_ms.train")(ctx) == pytest.approx(4.0)
    for name in READERS[:-3]:
        assert reader(name)(ctx) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(_program_spans, "recorder", lambda: None)
    for kind, n in (("enhance", "calls"), ("vocode", "calls"), ("train", "steps")):
        ctx = {"kind": kind, n: 3, "events": EVENTS, "window_s": 1e-6}
        assert all(reader(name)(ctx) is None for name in READERS)


@pytest.mark.parametrize("workload", ["enhance-flagship-r256", "vocode-diffwave-b16"])
def test_program_sampler_spans_match_the_benchmarks(workload):
    """A tiny run on the CPU under ``recording()``, with the driver's
    ``trace_wrap()``: each ``sampler.call`` the program records lies within
    0.5 ms of the benchmark's ``infer`` span of the same call, the program's
    ``sampler.step`` spans count the forwards the benchmark's hook counts,
    and the readers read the window."""
    from sddm_tpu_torch.utils import profiling

    from benchmark.tracing import ForwardCounter

    cell = tiny(workload)
    driver = KINDS[cell.traffic["kind"]](cell, SEED, "cpu")
    driver.setup()
    driver.trace_wrap()
    forwards = ForwardCounter(driver.trace_network())
    with profiling.recording() as spans:
        driver.window(0.5)
    forwards.remove()
    n = len(driver.calls)
    # one denoiser forward a step: the program's steps are the hook's forwards
    assert [s.name for s in spans].count("sampler.step") == forwards.count > 0
    ours = [s for s in spans if s.name == "sampler.call"]
    theirs = driver.spans.by_name["infer"]
    assert n > 0 and len(ours) == len(theirs) >= n
    for s, (w0, w1, _) in zip(ours, theirs):
        assert abs(s.start_ns - w0) < 5e5 and abs(s.end_ns - w1) < 5e5
    ctx = dict(kind=driver.kind, calls=n, events=[], window_s=driver.window_s,
               spans=driver.spans)
    assert reader("sampler_step_host_ms")(ctx) > 0
    if driver.kind == "enhance":
        host = reader("enhance_host_ms")(ctx)
        mine = reader("enhance_self_ms")(ctx) + reader("enhance_wait_ms")(ctx)
        assert abs(host - mine) < 0.5  # ms
        assert 0 <= reader("padded_share")(ctx) < 100
        assert reader("enhance_copy_ms")(ctx) > 0


@pytest.mark.chip
def test_launches_lie_inside_their_step(card):
    """A traced tiny sampler call on the card, CPU activity on: every kernel
    launch the host made inside ``sampler.call`` lies inside its
    ``sampler.prepare`` or a ``sampler.step`` span (0.1 ms), every step
    launches alike; prints the device's step against the host's clock over
    the window (each kernel's start less its launch's start)."""
    import statistics

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
    model.infer(cond, gen)  # the kernels' build and first launch outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):  # torch's flag, CUDA activity alone
        assert profiling.span("x") is not profiling.NO_SPAN
    mark = profiling.mark()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(5):
            model.infer(cond, gen)
        torch.cuda.synchronize()
        time.sleep(0.05)
    spans = profiling.spans(mark)
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    slack = 100_000  # 0.1 ms
    calls = [s for s in spans if s.name == "sampler.call"]
    assert len(calls) == 5
    for call in calls:
        inner = [s for s in spans if s.parent == call.id]
        steps = [s for s in inner if s.name == "sampler.step"]
        mine = [e for e in launches if call.start_ns - slack <= e.start_ns() <= call.end_ns + slack]
        assert len(steps) == 6 and mine
        for e in mine:
            assert any(s.start_ns - slack <= e.start_ns() and e.end_ns() <= s.end_ns + slack
                       for s in inner), (e.name(), e.start_ns() - call.start_ns)
        per_step = [sum(s.start_ns <= e.start_ns() <= s.end_ns for e in mine) for s in steps]
        assert len(set(per_step)) == 1 and per_step[0] > 0, per_step
    by_corr = {e.correlation_id(): e for e in launches}
    kernels = [e for e in events if e.device_type().name == "CUDA" and e.duration_ns() > 0
               and e.correlation_id() in by_corr]
    lead = [k.start_ns() - by_corr[k.correlation_id()].start_ns() for k in kernels]
    assert lead, "no kernel matched its launch by correlation id"
    per_call = [min(k.start_ns() - by_corr[k.correlation_id()].start_ns() for k in kernels
                    if c.start_ns <= by_corr[k.correlation_id()].start_ns() <= c.end_ns)
                for c in calls]
    print(f"device step: kernels {len(lead)}, kernel start less launch start min "
          f"{min(lead)} ns, median {statistics.median(lead)} ns, max {max(lead)} ns; "
          f"least by call {per_call} ns; "
          f"the idle readers' DEVICE_STEP_NS {_program_spans.DEVICE_STEP_NS}")
