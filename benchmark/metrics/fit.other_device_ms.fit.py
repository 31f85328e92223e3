"""Device milliseconds a fit step spends outside the render's autograd
node (its forward ``_RenderImage`` and its backward
``_RenderImageBackward``): the loss, the gradients' gather into the
leaves, the optimizer's update and the zeroing, from the profiler's trace,
a step's worth of the traced window."""


def read(ctx):
    s = ctx.get("summary")
    if ctx["loop"] != "fit" or s is None or s.device_s <= 0:
        return None
    render = s.by_span.get("_RenderImage", 0.0) + s.by_span.get("_RenderImageBackward", 0.0)
    return (s.device_s - render) / ctx["count"] * 1e3
