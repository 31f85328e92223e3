"""The image backward's share of its roofline, in percent: the least time
the pullback of a frame needs on an H100 (``harness/roofline.py``), over
the device time of the kernels launched inside the render's autograd node
in its backward (``_RenderImageBackward``), a step's worth of the traced
window.

The work the pullback needs is what the inputs need, not a replay of every
step for every pixel: one march to find each ray's settled step (the main
path keeps no history), the colour evaluation and the ray, then for a ray
that hits the taps' forward evaluations, the adjoint of the taps and of
each march step it took (one unit gradient of the distance each, its
operations the configuration's frozen ``counts``), the colour evaluation's
adjoint and the shading's pullback. Steps from the reference's own depth
history of the fitted scene. Bytes: the cotangent read, the parameters and
view read and their gradients written.
"""

from benchmark.harness import roofline as r


def need(counts: dict, needs: dict) -> tuple[float, float]:
    """(operations, bytes) of one frame's pullback."""
    step = counts["dist"] + r.STEP_OPS
    unit = counts["dist_unit"] + r.UNIT_OPS + counts["slots_added"]
    pixels, hits = needs["pixels"], needs["hits"]
    ops = (needs["steps"] * step + pixels * (counts["eval"] + r.RAY_OPS)
           + hits * (r.TAPS * step + r.TAPS * unit + counts["eval_vjp"] + 3 * r.SHADE_OPS)
           + needs["hit_steps"] * unit)
    return ops, pixels * 12 + 2 * 4 * (counts["n_params"] + 19)


def read(ctx):
    s = ctx.get("summary")
    if ctx["loop"] != "fit" or s is None or "needs" not in ctx:
        return None
    device_s = s.by_span.get("_RenderImageBackward", 0.0) / ctx["count"]
    if device_s <= 0:
        return None
    ops, nbytes = need(ctx["config"]["counts"], ctx["needs"])
    return 100.0 * r.least_seconds(ops, nbytes) / device_s
