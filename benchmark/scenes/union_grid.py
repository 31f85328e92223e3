"""The union grid through the port's DSL (``sphere``, ``translate``, ``|``),
from ``reference/union_grid.py``'s table, in the same pairing."""

from __future__ import annotations

import sdfkit_tpu_torch as st


def build(table: dict, device) -> st.SdfExpr:
    prims = [st.sphere(r, color=c, device=device).translate(o)
             for r, c, o in zip(table["radius"], table["color"], table["offset"])]
    while len(prims) > 1:
        paired = [a | b for a, b in zip(prims[::2], prims[1::2])]
        prims = paired + (prims[-1:] if len(prims) % 2 else [])
    return prims[0]


def leaves(expr: st.SdfExpr, name: str) -> list:
    """Each sphere's leaves are radius, colour, offset, in table order."""
    start = {"radius": 0, "color": 1, "offset": 2}[name]
    return st.leaves(expr)[start::3]
