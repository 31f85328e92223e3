"""Named scenes.

``sphere_repeat_scene`` is the hero scene the JAX package's ``bench.py``
renders (the reference's Perf console scene, Perf/Program.cs:5-22): a union of
RepeatXY spheres and RepeatXZ boxes with per-cell colour ``0.9 - |i|/6``.
Built here with the port's DSL and a callback written against ``ops``.
"""

from __future__ import annotations

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.sdf.expr import SdfExpr, box, sphere
from sdfkit_tpu_torch.utils.v3 import V3


def cell_color(i: V3, p: V3, c: V3, d) -> V3:
    return V3(
        0.9 - ops.abs(i.x) / 6.0,
        0.9 - ops.abs(i.y) / 6.0,
        0.9 - ops.abs(i.z) / 6.0,
    )


def sphere_repeat_scene(device=None) -> SdfExpr:
    """On ``device``, or the package's default device (the card)."""
    r = 0.5
    spheres = sphere(r, device=device).repeat_xy(2.25 * r, 2.25 * r, cell_color)
    boxes = box(r / 2, device=device).repeat_xz(3.0 * r, 3.0 * r, cell_color)
    return spheres | boxes
