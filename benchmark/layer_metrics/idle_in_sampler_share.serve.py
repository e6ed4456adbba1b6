"""Device: the share of the traced window in which the card ran nothing
while the host's innermost program span was the sampler's (``sampler.call``,
``sampler.prepare``, ``sampler.step``): idle time the sampler's launches
leave (``_program_spans.idle_share``)."""

from benchmark.layer_metrics._program_spans import idle_share


def read(ctx):
    if ctx.get("kind") not in ("enhance", "vocode"):
        return None
    return idle_share(ctx, lambda name: name.startswith("sampler."))
