"""Sampler: host wall of each ``infer`` call until it returns, before the
caller's synchronise (the launch cost of a call, the engine's ``prepare``
inside it), mean over calls."""

import numpy as np

from benchmark.tracing import last


def read(ctx):
    spans = last(ctx["spans"].seconds("infer"), ctx.get("calls", 0))
    if ctx["kind"] not in ("enhance", "vocode") or not spans:
        return None
    return float(np.mean(spans)) * 1e3
