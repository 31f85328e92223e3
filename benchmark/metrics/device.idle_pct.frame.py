"""The share of the traced window of frames, in percent, in which no
operation ran on the device (the union of kernels, copies and fills from
the profiler's trace, against the window's span)."""


def read(ctx):
    s = ctx.get("summary")
    if ctx["loop"] != "frames" or s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
