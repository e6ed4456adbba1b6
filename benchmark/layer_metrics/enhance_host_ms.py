"""Serving API: the host's share of an ``Enhancer.enhance_batch`` call, its
span less its sampler span (chunking, padding, the copies to and from the
card, the wait for the device and, on a mesh, the gather), mean over calls."""

import numpy as np

from benchmark.tracing import last


def read(ctx):
    n = ctx.get("calls", 0)
    calls = last(ctx["spans"].seconds("enhance_batch"), n)
    samplers = last(ctx["spans"].seconds("infer"), n)
    if ctx["kind"] != "enhance" or not calls or len(samplers) != len(calls):
        return None
    return float(np.mean(np.subtract(calls, samplers))) * 1e3
