"""The profiler-window logic and the reduction of a device trace, on
events made by hand."""

from __future__ import annotations

import itertools

from benchmark import tracing


def test_retry_windows_in_order_then_the_widest():
    first = list(itertools.islice(tracing.retry_windows(patience_s=0.0), 10))
    assert first == list(tracing.RETRY_WINDOWS)
    assert first[:3] == [(0.05, False)] * 3 and first[-1] == (2.0, True)
    more = tracing.retry_windows(patience_s=1.5)
    assert list(itertools.islice(more, 7))[-1] == (2.0, True)


EVENTS = [("k_a", 0, 10), ("k_b", 5, 20), ("nccl_x", 30, 40), ("k_a", 100, 110)]


def test_union_busy_and_names():
    assert tracing.merged(EVENTS) == [[0, 20], [30, 40], [100, 110]]
    assert tracing.busy_s(EVENTS) == 40e-9
    assert tracing.time_by_name(EVENTS)["k_a"] == 20e-9
    assert tracing.seconds_where(EVENTS, lambda n: n.startswith("nccl")) == 10e-9


def test_idle_gaps_are_named_by_the_innermost_span():
    spans = tracing.Spans()
    spans.by_name["call"].append((0, 200, 2e-7))
    spans.by_name["infer"].append((35, 80, 4.5e-8))
    gaps = tracing.idle_gaps(EVENTS, spans)
    assert gaps == [["host:infer", 60e-9], ["host:call", 10e-9]]


def test_spans_wrap_and_forward_counter():
    import torch

    spans = tracing.Spans()

    class Thing:
        def go(self, x):
            return x + 1

    t = Thing()
    spans.wrap(t, "go", "go")
    assert t.go(1) == 2 and len(spans.seconds("go")) == 1
    net = torch.nn.Linear(2, 2)
    counter = tracing.ForwardCounter(net)
    net(torch.zeros(1, 2))
    net(torch.zeros(1, 2))
    counter.remove()
    net(torch.zeros(1, 2))
    assert counter.count == 2
    assert tracing.last([1, 2, 3], 2) == [2, 3] and tracing.last([1, 2], 0) == []
