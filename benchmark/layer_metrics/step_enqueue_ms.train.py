"""Trainer: host wall of each ``train_step`` call until it returns (the
step is not synchronised), mean over the traced window's steps."""

import numpy as np

from benchmark.tracing import last


def read(ctx):
    spans = last(ctx["spans"].seconds("train_step"), ctx.get("steps", 0))
    if ctx["kind"] != "train" or not spans:
        return None
    return float(np.mean(spans)) * 1e3
