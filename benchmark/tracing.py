"""Spans, counters and the device trace of a traced run.

Spans are taken here, around the benchmark's calls into each layer of the
program, with the host's clock; counters count the forwards of a network
(a forward hook) and the calls made.  The device trace is a
``torch.profiler`` window of CUDA activity only.  The profiler keeps the
device events whose timestamps fall inside its window, and on an H100 the
device's timestamps step against the host's by milliseconds, now and then
for seconds the profiler sees no device event at all: a window is padded
with idle time at both ends and, where it came back empty, opened again,
wider (the logic frozen from the program's ``utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

PROFILE_MARGIN_S = 0.05
RETRY_WINDOWS = ((PROFILE_MARGIN_S, False),) * 3 + ((0.2, False), (1.0, True), (2.0, True))
PATIENCE_S = 60.0


def retry_windows(patience_s: float = PATIENCE_S):
    """``(margin s, trace the CPU too)`` of each window to open in turn until
    one holds device events: ``RETRY_WINDOWS``, then the widest a second
    apart until ``patience_s`` from the first."""
    start = time.monotonic()
    yield from RETRY_WINDOWS
    while time.monotonic() - start < patience_s:
        time.sleep(1.0)
        yield RETRY_WINDOWS[-1]


@contextlib.contextmanager
def profiled(margin_s: float, with_cpu: bool):
    """A profiler window over the block, padded by ``margin_s`` of idle time
    at each end (the device synchronised before the trailing pad)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_cpu else [])
    with profile(activities=acts) as prof:
        time.sleep(margin_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(margin_s)


def device_events(prof) -> list:
    """``[(name, start ns, end ns)]`` of every operation the device ran
    (kernels, copies, sets), in start order."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.end_ns()))
    out.sort(key=lambda r: r[1])
    return out


def merged(events) -> list:
    """The union of the events' intervals, ``[(start ns, end ns)]``."""
    spans = []
    for _, s, e in events:
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return spans


def busy_s(events) -> float:
    return sum(e - s for s, e in merged(events)) / 1e9


def time_by_name(events) -> dict:
    total = defaultdict(float)
    for name, s, e in events:
        total[name] += (e - s) / 1e9
    return dict(total)


class Spans:
    """Host spans by name: ``with spans("name"):`` records ``(start, end)``
    in ``time.time_ns`` (the clock the device trace is aligned to) and
    ``time.perf_counter`` seconds."""

    def __init__(self):
        self.by_name = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.by_name[name].append((w0, time.time_ns(), time.perf_counter() - t0))

    def seconds(self, name: str) -> list:
        return [d for _, _, d in self.by_name.get(name, [])]

    def wrap(self, obj, attr: str, name: str):
        """Time every call of ``obj.attr`` (an instance attribute shadows the
        method) as span ``name``."""
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, timed)


def idle_gaps(events, spans: Spans, top: int = 10) -> list:
    """The ``top`` longest gaps between device operations, each named by the
    innermost host span its midpoint falls in (``host:<name>``, or
    ``host:outside-spans``): ``[[name, seconds]]``."""
    union = merged(events)
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(union, union[1:])),
                  reverse=True)[:top]
    out = []
    for length, e0, s1 in gaps:
        mid = (e0 + s1) // 2
        label, width = "host:outside-spans", None
        for name, items in spans.by_name.items():
            for w0, w1, _ in items:
                if w0 <= mid <= w1 and (width is None or w1 - w0 < width):
                    label, width = f"host:{name}", w1 - w0
        out.append([label, length / 1e9])
    return out


class ForwardCounter:
    """Counts the forwards of a module through a forward hook."""

    def __init__(self, module: torch.nn.Module):
        self.count = 0
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, *_):
        self.count += 1

    def remove(self):
        self.handle.remove()


def seconds_where(events, match) -> float:
    """Device seconds of the events whose name ``match`` accepts."""
    return sum(e - s for name, s, e in events if match(name)) / 1e9


def last(values: list, n: int) -> list:
    return values[-n:] if n else []
