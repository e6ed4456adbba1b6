"""Device: the model's FLOPs of the traced window's train steps (the plain
reference's forward and backward, counted by ``torch.utils.flop_counter``)
over the window's seconds and the chips' bf16 peak."""

from benchmark.counts.peaks import BF16_OPS_PER_S


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("steps"):
        return None
    return 100.0 * ctx["steps"] * ctx["flops_per_step"] / ctx["window_s"] / (
        BF16_OPS_PER_S * ctx["chips"])
