"""Device: the share of the traced window in which no operation ran on the
card (1 less the union of the device events' intervals over the window)."""


def read(ctx):
    if ctx["kind"] not in ("enhance", "vocode") or not ctx["events"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
