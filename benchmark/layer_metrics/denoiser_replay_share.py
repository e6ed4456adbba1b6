"""Denoiser: the share of the window's sampler steps whose denoiser forward
replayed a CUDA graph, in %: 100 x the ``sampler.step`` spans that hold a
``denoiser.replay`` span (the packed engine's, inside its forward) over all
the window's ``sampler.step`` spans.  It counts how often the graph engages;
0 from a program that records steps but replays none."""

from benchmark.layer_metrics._program_spans import trees


def read(ctx):
    if ctx.get("kind") not in ("enhance", "vocode"):
        return None
    found = trees(ctx)
    steps = replayed = 0
    for _, inside in found or ():
        by_id = {s.id: s for s in inside}
        holding = set()
        for s in inside:
            if s.name != "denoiser.replay":
                continue
            up = by_id.get(s.parent)
            while up is not None and up.name != "sampler.step":
                up = by_id.get(up.parent)
            if up is not None:
                holding.add(up.id)
        steps += sum(s.name == "sampler.step" for s in inside)
        replayed += len(holding)
    return 100.0 * replayed / steps if steps else None
