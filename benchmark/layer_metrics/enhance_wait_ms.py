"""Serving API: the host's wait for the card in an ``Enhancer.enhance_batch``
call, from the program's spans: ``enhance.wait`` (after each block's
sampler call returns, until its outputs are ready; on a mesh the gather too),
summed a call, mean."""

from benchmark.layer_metrics._program_spans import ms, trees


def read(ctx):
    if ctx.get("kind") != "enhance":
        return None
    found = trees(ctx)
    if not found:
        return None
    return sum(ms(inside, "enhance.wait") for _, inside in found) / len(found)
