"""Device: the share of the traced window in which the card ran nothing
while the host's innermost program span was the serving API's own work
(``enhance.*`` other than ``enhance.wait``: chunking, padding, the copies,
the answers' split; ``_program_spans.idle_share``)."""

from benchmark.layer_metrics._program_spans import idle_share


def read(ctx):
    if ctx.get("kind") != "enhance":
        return None
    return idle_share(ctx, lambda name: name.startswith("enhance.") and name != "enhance.wait")
