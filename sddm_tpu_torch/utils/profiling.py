"""A ``torch.profiler`` window that keeps the kernels it runs.

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

import contextlib
import time

PROFILE_MARGIN_S = 0.05
# The windows a measurement opens, in order, until one holds the launches it
# looks for: (margin in seconds, whether the CPU activity is traced too).  In
# full chip_smoke.py runs on an H100 (PR 16) the profiler now and then saw no
# device event at all for a second or two: three padded windows in a row came
# back empty, then a window of 0.2 s margins, or of 1 s with the CPU traced
# too, held the kernels.
RETRY_WINDOWS = ((PROFILE_MARGIN_S, False),) * 3 + ((0.2, False), (1.0, True), (2.0, True))


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
