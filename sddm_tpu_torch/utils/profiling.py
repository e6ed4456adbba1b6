"""A ``torch.profiler`` window that keeps the kernels it runs, and the
program's own spans (``span``, ``recording``, ``chrome_events``; below).

The profiler keeps only the device events whose timestamps fall inside its
window, and the device's timestamps step against the host's clock by
milliseconds: on an H100 (torch 2.11, CUDA 12.8) they stepped about every
10 s, and a kernel's start then read up to 7.7 ms before the host launched
it; a window that began right before its first launch and ended right after
its last lost every kernel in about one window of 100
(``python -m sddm_tpu_torch.profiler_window_probe``).  :func:`profiled` pads
the window with idle time at each end, inside it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

PROFILE_MARGIN_S = 0.05
# The windows a measurement opens, in order, until one holds the launches it
# looks for: (margin in seconds, whether the CPU activity is traced too).  In
# full chip_smoke.py runs on an H100 (PR 16) the profiler now and then saw no
# device event at all for a second or two: three padded windows in a row came
# back empty, then a window of 0.2 s margins, or of 1 s with the CPU traced
# too, held the kernels.
RETRY_WINDOWS = ((PROFILE_MARGIN_S, False),) * 3 + ((0.2, False), (1.0, True), (2.0, True))
# A later full chip_smoke.py run on an H100 found every window of
# RETRY_WINDOWS empty, about 8 s of them in a row: a measurement then goes on
# with the widest window, a second apart, until this long after its first.
PATIENCE_S = 60.0


def retry_windows(patience_s: float = PATIENCE_S):
    """The windows a measurement opens until one holds what it looks for:
    ``RETRY_WINDOWS`` in turn, then the widest of them a second apart until
    ``patience_s`` seconds have passed since the first.  Each is ``(margin in
    seconds, whether the CPU activity is traced too)``."""
    start = time.monotonic()
    yield from RETRY_WINDOWS
    while time.monotonic() - start < patience_s:
        time.sleep(1.0)
        yield RETRY_WINDOWS[-1]


@contextlib.contextmanager
def profiled(*activities, margin_s: float = PROFILE_MARGIN_S):
    """``torch.profiler.profile(activities=activities)`` over the block, with
    ``margin_s`` of idle time inside the window before the block and after
    it (the device, where there is one, is synchronized first)."""
    import torch
    from torch.profiler import profile

    with profile(activities=list(activities)) as prof:
        time.sleep(margin_s)
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(margin_s)


# ---- spans ---------------------------------------------------------------------------
#
# The program's own tracing: spans at the layer boundaries (the serving API, the
# sampler, the train step).  A span records only while a torch.profiler window is
# open (torch's own flag) or inside ``recording()``; otherwise ``span()`` hands back
# one shared no-op context and reads no clock.  Spans are stamped with
# ``time.time_ns()``, the clock of the profiler's host events, so that they lie
# beside its trace.  They are kept apart from the profiler's events: a
# ``torch.profiler.record_function`` would add a device event over each span's
# kernels in a window that traces the CPU too, which readers of the device's
# events would count as work.

MAX_SPANS = 1 << 20  # spans kept in memory; beyond it the oldest are dropped


class _NoSpan:
    """The context ``span()`` returns while nothing records: ``as`` gives None."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Span:
    """One recorded span: ``name``, ``id``, ``parent`` (the enclosing span's
    id on this thread, None for a root), ``root`` (the outermost span's id,
    shared by every span of one call), ``start_ns``/``end_ns``
    (``time.time_ns``), ``thread`` (the OS thread id, as the profiler's
    trace names threads) and ``attrs``."""

    __slots__ = ("_recorder", "name", "id", "parent", "root", "start_ns", "end_ns", "thread",
                 "attrs", "_device", "_events")

    def __init__(self, recorder, name: str, attrs: dict, device: bool):
        self._recorder, self.name, self.attrs = recorder, name, attrs
        self._device, self._events = bool(device), None
        self.end_ns = None

    def __enter__(self):
        stack = self._recorder._stack()
        outer = stack[-1] if stack else None
        self.id = next(self._recorder._ids)
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        self.thread = self._recorder._local.thread
        stack.append(self)
        if self._device:
            import torch

            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.time_ns()
        self._recorder._stack().pop()
        self._recorder._keep(self)
        return False

    @property
    def ms(self) -> float:
        """Host wall of the span in milliseconds."""
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self):
        """The card's time between the span's start and end on the stream
        that was current (CUDA events; synchronises on the end event), for a
        span opened with ``device=True`` on a card; None otherwise."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"attrs={self.attrs})")


class Recorder:
    """The spans of one process (``RECORDER``; a test may make its own).
    Thread-safe: each thread keeps its own stack of open spans.  ``dropped``
    counts the spans dropped beyond ``MAX_SPANS``."""

    def __init__(self):
        from torch.autograd import profiler

        self._profiler = profiler  # its ``_is_profiler_enabled``: a window is open
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans = collections.deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self._on = 0  # the depth of open ``recording()`` blocks

    def span(self, name: str, device: bool = False, **attrs):
        """A context that records a span ``name`` with ``attrs`` while a
        profiler window or a :meth:`recording` block is open, ``as`` giving
        the :class:`Span`; otherwise the shared no-op ``NO_SPAN`` (``as``
        gives None).  ``device=True`` also times the block on the card with a
        pair of CUDA events (see ``Span.device_ms``)."""
        if not self._on and not self._profiler._is_profiler_enabled:
            return NO_SPAN
        return Span(self, name, attrs, device)

    def _stack(self) -> list:
        """This thread's open spans (its OS id kept beside them)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self._local.thread = threading.get_native_id()
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def mark(self) -> int:
        """A mark: :meth:`spans` ``(since=mark)`` gives the spans opened after it."""
        return next(self._ids)

    def spans(self, since: int = 0) -> list:
        """The spans kept, opened after the mark ``since``, in the order they ended."""
        with self._lock:
            return [s for s in self._spans if s.id > since]

    @contextlib.contextmanager
    def recording(self):
        """Record spans inside the block, whether a profiler window is open or
        not (the operator's switch); yields a list that holds the block's
        spans when it ends."""
        since = self.mark()
        with self._lock:
            self._on += 1
        block: list = []
        try:
            yield block
        finally:
            with self._lock:
                self._on -= 1
            block.extend(self.spans(since))


def chrome_events(spans, base_ns: int = 0) -> list:
    """``spans`` as Chrome-trace ``"X"`` events, ``ts`` in microseconds after
    ``base_ns`` (epoch nanoseconds)."""
    pid = os.getpid()
    out = []
    for s in spans:
        args = dict(s.attrs, id=s.id, parent=s.parent, root=s.root)
        if s._events is not None:
            args["device_ms"] = s.device_ms
        out.append({"name": s.name, "cat": "program", "ph": "X", "pid": pid, "tid": s.thread,
                    "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": args})
    return out


RECORDER = Recorder()
span = RECORDER.span
recording = RECORDER.recording
spans = RECORDER.spans
mark = RECORDER.mark
