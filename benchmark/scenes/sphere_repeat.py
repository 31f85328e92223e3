"""SphereRepeat through the port's DSL, from ``reference/sphere_repeat.py``'s table."""

from __future__ import annotations

import sdfkit_tpu_torch as st


def cell_colour(i, p, c, d):
    return st.V3(0.9 - st.ops.abs(i.x) / 6.0, 0.9 - st.ops.abs(i.y) / 6.0,
                 0.9 - st.ops.abs(i.z) / 6.0)


def build(table: dict, device) -> st.SdfExpr:
    cell, box_cell = table["sphere_cell"], table["box_cell"]
    spheres = st.sphere(table["sphere_radius"], color=table["sphere_rgb"], device=device)
    boxes = st.box(table["box_bounds"], color=table["box_rgb"], device=device)
    return (spheres.repeat_xy(cell[0], cell[1], cell_colour)
            | boxes.repeat_xz(box_cell[0], box_cell[1], cell_colour))


def leaves(expr: st.SdfExpr, name: str) -> list:
    """The port's leaves of table entry ``name``, one per row of it."""
    found = st.leaves(expr)
    index = {"sphere_radius": [0], "sphere_rgb": [1], "sphere_cell": [2, 3],
             "box_bounds": [4], "box_rgb": [5], "box_cell": [6, 7]}[name]
    return [found[i] for i in index]
