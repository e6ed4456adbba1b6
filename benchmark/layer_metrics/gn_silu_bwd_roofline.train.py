"""Kernels: the NCHW GroupNorm+SiLU backward kernel's share of its
roofline in training: the least time of every site of every step
(``counts/gn_silu.py`` on the logical sites) over the device time of the
``gn_silu_bwd_run`` kernels."""

from benchmark.counts.gn_silu import backward_bound_s
from benchmark.tracing import seconds_where


def read(ctx):
    if ctx["kind"] != "train":
        return None
    device = seconds_where(ctx["events"], lambda name: "gn_silu_bwd_run" in name)
    if device <= 0:
        return None
    bound = ctx["steps"] * sum(backward_bound_s(shape, ctx["element_size"])
                               for shape, _ in ctx["gn_sites"])
    return 100.0 * bound / device
