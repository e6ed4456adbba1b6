"""Kernels: the NHWC GroupNorm+SiLU kernel's share of its roofline: the
least time of every site of every forward counted (``counts/gn_silu.py``
on the logical sites of the plain reference) over the device time of the
``nhwc_gn_silu`` kernels."""

from benchmark.counts.gn_silu import forward_bound_s
from benchmark.tracing import seconds_where


def read(ctx):
    if "gn_sites" not in ctx or ctx["kind"] == "train":
        return None
    device = seconds_where(ctx["events"], lambda name: "nhwc_gn_silu" in name)
    if device <= 0:
        return None
    bound = ctx["forwards"] * sum(forward_bound_s(shape, ctx["element_size"])
                                  for shape, _ in ctx["gn_sites"])
    return 100.0 * bound / device
