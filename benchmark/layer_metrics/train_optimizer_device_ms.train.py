"""Trainer, training network: the card's time of the train step's
``train.optimizer`` phase (the optimizer's step), from the
program's spans' CUDA events, mean over the window's steps: the stream's
elapsed time, the card's idle inside the phase included (see
``_program_spans.phase_device_ms``)."""

from benchmark.layer_metrics._program_spans import phase_device_ms


def read(ctx):
    return phase_device_ms(ctx, "train.optimizer")
