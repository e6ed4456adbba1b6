"""Device: the peak of device memory allocated in the run after set-up
(``max_memory_allocated`` after a reset), in GiB."""


def read(ctx):
    if ctx["kind"] not in ("enhance", "vocode") or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2**30
