"""Serving API: the share of the sampled work that is padding, from the
``enhance.call`` spans' attributes: 100 x (1 - samples in / samples sampled)
over the window's calls (each request's last row padded to the row length,
each call's last block padded with zero rows)."""

from benchmark.layer_metrics._program_spans import trees


def read(ctx):
    if ctx.get("kind") != "enhance":
        return None
    found = trees(ctx)
    if not found:
        return None
    sampled = sum(r.attrs["samples_sampled"] for r, _ in found)
    return 100.0 * (1.0 - sum(r.attrs["samples_in"] for r, _ in found) / sampled)
