"""Named scenes.

``sphere_repeat_scene`` is the hero scene the JAX package's ``bench.py``
renders (the reference's Perf console scene, Perf/Program.cs:5-22): a union of
RepeatXY spheres and RepeatXZ boxes with per-cell colour ``0.9 - |i|/6``.
Built here with the port's DSL and a callback written against ``ops``.

``union_grid_scene`` is the fitting-sized scene: a balanced union of coloured,
translated spheres, the shape class the JAX package's Pallas kernel sizes its
large-tree tier for (``tests/test_pallas_kernel.py`` ``_union_tree``: seven
scalars a sphere, 1,400 at 200 spheres).
"""

from __future__ import annotations

import numpy as np

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


GRID_COLUMNS = 20
GRID_SPACING = 0.55  # 20 columns fill the default camera's 1920x1080 frame at z = 0


def union_grid_table(n: int = 200, seed: int = 0) -> dict:
    """The spheres of ``union_grid_scene`` as float32 arrays: ``radius`` (n,),
    ``color`` and ``offset`` (n, 3). Sphere k sits at column k % 20 and row
    k // 20 of a grid centred on the origin in the plane z = 0 (20 x 10 at
    n = 200), radius 0.47 to 0.62 of the spacing, so that neighbours touch or
    overlap and most of the default camera's frame is surface. Radii and
    colours come from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    rows = -(-n // GRID_COLUMNS)
    k = np.arange(n)
    offset = np.stack([(k % GRID_COLUMNS - (GRID_COLUMNS - 1) / 2) * GRID_SPACING,
                       ((rows - 1) / 2 - k // GRID_COLUMNS) * GRID_SPACING, np.zeros(n)], -1)
    return {"radius": rng.uniform(0.26, 0.34, n).astype(np.float32),
            "color": rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
            "offset": offset.astype(np.float32)}


def balanced_union(prims: list):
    """The union of ``prims`` paired level by level (an odd one out goes up
    a level as it is): depth log2(n), the shape of ``_union_tree``."""
    while len(prims) > 1:
        paired = [a | b for a, b in zip(prims[::2], prims[1::2])]
        prims = paired + (prims[-1:] if len(prims) % 2 else [])
    return prims[0]


def union_grid_scene(n: int = 200, seed: int = 0, device=None) -> SdfExpr:
    """A balanced union of ``n`` coloured spheres on a grid
    (``union_grid_table``), 7 scalars a sphere in leaf order radius, colour,
    offset: 1,400 at the default ``n``. On ``device``, or the package's
    default device (the card)."""
    t = union_grid_table(n, seed)
    return balanced_union([
        sphere(float(r), color=tuple(map(float, c)), device=device).translate(*map(float, o))
        for r, c, o in zip(t["radius"], t["color"], t["offset"])
    ])
