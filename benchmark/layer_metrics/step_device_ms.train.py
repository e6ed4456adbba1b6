"""Trainer and training network: device time of every operation in the
traced window over the train steps there."""

from benchmark.tracing import seconds_where


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("steps") or not ctx["events"]:
        return None
    return seconds_where(ctx["events"], lambda name: True) / ctx["steps"] * 1e3
