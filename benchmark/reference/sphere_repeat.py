"""SphereRepeat (praeclarum/SdfKit ``Perf/Program.cs:5-22``): RepeatXY
spheres unioned with RepeatXZ boxes, each cell coloured ``0.9 - |i| / 6``.

The table holds the scene's parameters under the names a configuration
uses: ``sphere_radius`` (), ``sphere_rgb`` (3), ``sphere_cell`` (the XY
repeat's two sizes), ``box_bounds`` (3), ``box_rgb`` (3), ``box_cell`` (the
XZ repeat's sizes). The published scene derives them from one radius r:
the spheres r, their cells 2.25 r, the boxes r / 2, their cells 3 r.
"""

from __future__ import annotations

import torch



def table(spec: dict, device) -> dict:
    """The parameters of ``spec`` (a configuration's ``scene``) as float32
    tensors on ``device``."""
    r = float(spec["radius"])
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return {"sphere_radius": f(r), "sphere_rgb": f([1.0, 1.0, 1.0]),
            "sphere_cell": f([2.25 * r, 2.25 * r]), "box_bounds": f([r / 2] * 3),
            "box_rgb": f([1.0, 1.0, 1.0]), "box_cell": f([3.0 * r, 3.0 * r])}


def block_pixels(default: int) -> int:
    return default


def _repeat(p, axes, sizes):
    """The point warped into its cell, and the cell's index."""
    comps, index = list(p), [torch.zeros_like(p[0])] * 3
    for axis, size in zip(axes, sizes):
        k = "xyz".index(axis)
        half = size * 0.5
        a = comps[k] + half
        comps[k] = a - size * torch.floor(a / size) - half
        index[k] = torch.floor((p[k] + half) / size)
    return tuple(comps), index


def _cell_colour(index):
    return tuple(0.9 - torch.abs(i) / 6.0 for i in index)


def _sphere(params, p):
    q, index = _repeat(p, "xy", (params["sphere_cell"][0], params["sphere_cell"][1]))
    d = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]) - params["sphere_radius"]
    return _cell_colour(index), d


def _box(params, p):
    q, index = _repeat(p, "xz", (params["box_cell"][0], params["box_cell"][1]))
    b = params["box_bounds"]
    w = [torch.abs(q[k]) - b[k] for k in range(3)]
    zero = torch.zeros_like(w[0])
    out = [torch.maximum(c, zero) for c in w]
    ssq = out[0] * out[0] + out[1] * out[1] + out[2] * out[2]
    is_zero = ssq == 0
    outside = torch.where(is_zero, zero, torch.sqrt(torch.where(is_zero, torch.ones_like(ssq), ssq)))
    inside = [torch.minimum(c, zero) for c in w]
    inside = torch.maximum(inside[0], torch.maximum(inside[1], inside[2]))
    return _cell_colour(index), outside + inside


def eval(params: dict, p):  # noqa: A001 -- the scene's evaluation, as the renderer names it
    ca, da = _sphere(params, p)
    cb, db = _box(params, p)
    pick = da < db
    return tuple(torch.where(pick, a, b) for a, b in zip(ca, cb)), torch.minimum(da, db)


def distance(params: dict, p):
    return torch.minimum(_sphere(params, p)[1], _box(params, p)[1])
