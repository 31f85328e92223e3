"""The image forward's share of its roofline, in percent: the least time
the work of a frame needs on an H100 (``harness/roofline.py``), over the
device time of the kernels launched inside the render's autograd node in
its forward (``_RenderImage``), a frame's worth of the traced window.

The work a frame needs: each ray marches to its settled step and the step
that shows it (the reference's own depth history at the traced views),
evaluates colour once, and a ray that hits takes the normal's six taps and
the shading while one that misses takes the sky; the scene's operations
per distance and per evaluation are the configuration's frozen ``counts``.
Bytes: the RGB frame written, the parameters and view read once.
"""

from benchmark.harness import roofline as r


def need(counts: dict, needs: dict) -> tuple[float, float]:
    """(operations, bytes) of one frame."""
    step = counts["dist"] + r.STEP_OPS
    pixels, hits = needs["pixels"], needs["hits"]
    ops = (needs["steps"] * step + pixels * counts["eval"]
           + hits * (r.TAPS * step + r.SHADE_OPS) + (pixels - hits) * r.RAY_OPS)
    return ops, pixels * 12 + 4 * (counts["n_params"] + 19)


def read(ctx):
    s = ctx.get("summary")
    if ctx["loop"] != "frames" or s is None or "needs" not in ctx:
        return None
    device_s = s.by_span.get("_RenderImage", 0.0) / ctx["count"]
    if device_s <= 0:
        return None
    ops, nbytes = need(ctx["config"]["counts"], ctx["needs"])
    return 100.0 * r.least_seconds(ops, nbytes) / device_s
