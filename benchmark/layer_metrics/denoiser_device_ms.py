"""Denoiser: device time of every operation in the traced window over the
denoiser's forwards counted there (the sampler's own elementwise work and
the copies included)."""

from benchmark.tracing import seconds_where


def read(ctx):
    if ctx["kind"] not in ("enhance", "vocode") or not ctx["forwards"] or not ctx["events"]:
        return None
    return seconds_where(ctx["events"], lambda name: True) / ctx["forwards"] * 1e3
