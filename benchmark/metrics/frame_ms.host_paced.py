"""The closed loop's frame time in the cells whose end-to-end frame time
is the device's (``frame_device_ms``): the traced window over its frames,
each ``render(camera=view_k)`` and a synchronise. The host sets this pace,
and the profiler's own cost on the host is in it."""


def read(ctx):
    if ctx["loop"] != "frames" or not ctx["count"]:
        return None
    return ctx["window_s"] / ctx["count"] * 1e3
