"""Serving API: the host's own work in an ``Enhancer.enhance_batch`` call,
from the program's spans: ``enhance.call`` less the time its ``sampler.call``
and ``enhance.wait`` children cover (chunking, padding, the copies, the
answers' split), mean over the window's calls."""

from benchmark.layer_metrics._program_spans import ms, trees


def read(ctx):
    if ctx.get("kind") != "enhance":
        return None
    found = trees(ctx)
    if not found:
        return None
    return sum(r.ms - ms(inside, "sampler.call", "enhance.wait")
               for r, inside in found) / len(found)
