"""Serving API: the copies of an ``Enhancer.enhance_batch`` call, from the
program's spans: ``enhance.to_device`` (padding and the pageable copy to the
card) and ``enhance.to_host`` (the copy back), summed a call, mean."""

from benchmark.layer_metrics._program_spans import ms, trees


def read(ctx):
    if ctx.get("kind") != "enhance":
        return None
    found = trees(ctx)
    if not found:
        return None
    return sum(ms(inside, "enhance.to_device", "enhance.to_host")
               for _, inside in found) / len(found)
