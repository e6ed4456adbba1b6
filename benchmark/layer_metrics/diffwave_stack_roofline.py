"""Kernels: the DiffWave residual-stack kernels' share of their roofline:
the least time of a stack call (``counts/diffwave_stack.py``) times the
forwards counted, over the device time of the stack's layer kernels
(``layer_wgmma``, ``layer_bf16``, ``layer_f32``)."""

from benchmark.counts.diffwave_stack import call_bound_s
from benchmark.tracing import seconds_where

KERNELS = ("layer_wgmma", "layer_bf16", "layer_f32")


def read(ctx):
    if ctx["kind"] != "vocode":
        return None
    device = seconds_where(ctx["events"], lambda name: any(k in name for k in KERNELS))
    if device <= 0:
        return None
    s = ctx["stack"]
    bound = ctx["forwards"] * call_bound_s(s["B"], s["T"], s["C"], s["L"], ctx["element_size"])
    return 100.0 * bound / device
