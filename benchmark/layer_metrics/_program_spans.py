"""What the readers of the program's own spans share (``sddm_tpu_torch.utils.
profiling``: ``enhance.*``, ``sampler.*``, ``train.*``): the traced window's
span trees, and the card's idle time in the window attributed to the span
the host was in.

A traced window records the program's spans by itself (they record while a
``torch.profiler`` window is open).  The window's trees are the last
``ctx["calls"]`` (``ctx["steps"]``) roots of the cell's kind; a retried
window's earlier roots come before them.  Against a program that has no
recorder (the parent of the change that added it) every function returns
None, so that the readers report nothing.
"""

from __future__ import annotations

from benchmark.tracing import merged

ROOTS = {"enhance": "enhance.call", "vocode": "sampler.call", "train": "train.step"}
# host time = device time - DEVICE_STEP_NS: the step of the profiler's device
# timestamps against the host's clock that the idle readers correct for.  The
# chip test ``test_bench_program_spans.py::test_launches_lie_inside_their_step``
# reads it: on H100s it read from none to 0.36 ms early, by machine and process,
# so no one offset holds, and 0.4 ms is small against the gaps attributed
DEVICE_STEP_NS = 0


def recorder():
    """The program's span recorder, None where the program has none."""
    try:
        from sddm_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def trees(ctx):
    """``[(root, [its descendants])]`` of the traced window, None where there
    are none (or fewer than the window's calls), or where the recorder has
    dropped spans, so that a tree may lack some."""
    n = ctx.get("steps" if ctx.get("kind") == "train" else "calls", 0)
    name = ROOTS.get(ctx.get("kind"))
    rec = recorder()
    if not n or name is None or rec is None or getattr(rec, "dropped", 0):
        return None
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None and s.name == name][-n:]
    if len(roots) < n:
        return None
    inside = {r.id: [] for r in roots}
    for s in spans:
        if s.parent is not None and s.root in inside:
            inside[s.root].append(s)
    return [(r, inside[r.id]) for r in roots]


def ms(spans, *names) -> float:
    """The summed wall of ``spans`` named one of ``names``, in ms."""
    return sum(s.ms for s in spans if s.name in names)


def innermost(spans) -> list:
    """``[(start ns, end ns, name)]``, disjoint and in order: the innermost
    span at each moment some span of ``spans`` (nested, one thread) covers."""
    out, stack, cursor = [], [], None

    def close(until):
        nonlocal cursor
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > cursor:
                out.append((cursor, end, name))
                cursor = end

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close(s.start_ns)
        if stack and s.start_ns > cursor:
            out.append((cursor, s.start_ns, stack[-1][1]))
        cursor = s.start_ns
        stack.append((s.end_ns, s.name))
    close(float("inf"))
    return out


def overlap_ns(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals ``(start, end, ...)``."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(ctx, match):
    """% of the window in which the card ran nothing while the host's
    innermost program span had a name ``match`` accepts: the gaps between the
    merged device events, from the first to the last, on the host's clock."""
    if not ctx.get("events") or ctx.get("window_s", 0) <= 0:
        return None
    found = trees(ctx)
    if found is None:
        return None
    union = merged(ctx["events"])
    gaps = [(e0 - DEVICE_STEP_NS, s1 - DEVICE_STEP_NS)
            for (_, e0), (s1, _) in zip(union, union[1:])]
    flat = [s for root, inside in found for s in [root, *inside]]
    hit = [seg for seg in innermost(flat) if match(seg[2])]
    return 100.0 * overlap_ns(gaps, hit) / 1e9 / ctx["window_s"]


def phase_device_ms(ctx, name):
    """The mean over the window's train steps of the card's time of their
    phase ``name`` (the span's CUDA events), None without them.  It is the
    stream's elapsed time between the events, so the card's idle inside the
    phase counts too: less host time per launch (a CUDA graph of the step)
    lowers it with no change to the device's work."""
    if ctx.get("kind") != "train":
        return None
    found = trees(ctx)
    times = [s.device_ms for _, inside in found or () for s in inside if s.name == name]
    if not times or None in times:
        return None
    return sum(times) / len(times)
