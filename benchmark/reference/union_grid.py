"""A balanced union of coloured, translated spheres on a grid: sphere k at
column ``k % columns`` and row ``k // columns`` of a grid centred on the
origin in the plane z = 0, unioned pairwise level by level (an odd one out
goes up a level as it is), the nearer's colour taken (``a`` where
``d_a < d_b``, else ``b``).

The table: ``radius`` (n,), ``color`` (n, 3), ``offset`` (n, 3). Radii and
colours are drawn uniformly on the device from ``table_seed``; the grid
fixes the offsets.
"""

from __future__ import annotations

import torch


def table(spec: dict, device) -> dict:
    n, cols, spacing = int(spec["count"]), int(spec["columns"]), float(spec["spacing"])
    gen = torch.Generator(device=device).manual_seed(int(spec["table_seed"]))
    lo, hi = spec["radius"]
    radius = lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
    clo, chi = spec["color"]
    color = clo + (chi - clo) * torch.rand((n, 3), generator=gen, device=device)
    rows = -(-n // cols)
    k = torch.arange(n, device=device, dtype=torch.float32)
    col, row = torch.remainder(k, cols), torch.div(k, cols, rounding_mode="floor")
    offset = torch.stack([(col - (cols - 1) / 2) * spacing, ((rows - 1) / 2 - row) * spacing,
                          torch.zeros_like(k)], -1)
    return {"radius": radius, "color": color, "offset": offset}


def block_pixels(default: int) -> int:
    """Every evaluation holds an (n, pixels) array: a block of a quarter of
    the pixels keeps an autograd tape of the march within some 25 GB, in
    few enough blocks that the launches do not set the pace."""
    return max(1, default // 4)


def _spheres(params: dict, p):
    """(n, ...) distances of every sphere at the points ``p``."""
    o = params["offset"]
    shape = (-1,) + (1,) * p[0].ndim
    q = [p[k][None] - o[:, k].reshape(shape) for k in range(3)]
    return torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]) - params["radius"].reshape(shape)


def _pairwise(d, c=None):
    """Reduce the leading axis by the balanced union's pairing."""
    while d.shape[0] > 1:
        a, b = d[0:-1:2] if d.shape[0] % 2 else d[0::2], d[1::2]
        odd = d.shape[0] % 2
        if c is not None:
            ca, cb = c[0:-1:2] if odd else c[0::2], c[1::2]
            pick = (a < b).unsqueeze(-1)
            merged = torch.where(pick, ca, cb)
            c = torch.cat([merged, c[-1:]]) if odd else merged
        merged = torch.minimum(a, b)
        d = torch.cat([merged, d[-1:]]) if odd else merged
    return d[0], (None if c is None else c[0])


def eval(params: dict, p):  # noqa: A001 -- the scene's evaluation, as the renderer names it
    d = _spheres(params, p)
    shape = (d.shape[0],) + (1,) * p[0].ndim + (3,)
    c = params["color"].reshape(shape).expand(*d.shape, 3)
    dist, colour = _pairwise(d, c)
    return (colour[..., 0], colour[..., 1], colour[..., 2]), dist


def distance(params: dict, p):
    return _pairwise(_spheres(params, p))[0]
