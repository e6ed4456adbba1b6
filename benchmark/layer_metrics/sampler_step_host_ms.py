"""Sampler: the host's wall of one reverse step, from the program's
``sampler.step`` spans (the denoiser's forward and the transition launched;
where the card paces, the launches' wait for room in its queue), mean over
the window's steps."""

from benchmark.layer_metrics._program_spans import trees


def read(ctx):
    if ctx.get("kind") not in ("enhance", "vocode"):
        return None
    found = trees(ctx)
    steps = [s.ms for _, inside in found or () for s in inside if s.name == "sampler.step"]
    return sum(steps) / len(steps) if steps else None
