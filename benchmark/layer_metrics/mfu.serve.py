"""Device: the model's FLOPs in the traced window (the plain reference's,
counted by ``torch.utils.flop_counter``: a forward's times the forwards
counted, plus what a call computes once) over the window's seconds and the
chips' bf16 peak."""

from benchmark.counts.peaks import BF16_OPS_PER_S


def read(ctx):
    if ctx["kind"] not in ("enhance", "vocode") or not ctx["forwards"]:
        return None
    flops = ctx["forwards"] * ctx["flops_per_forward"] + ctx["calls"] * ctx["flops_per_call"]
    return 100.0 * flops / ctx["window_s"] / (BF16_OPS_PER_S * ctx["chips"])
