"""Dense voxel-grid sampling of an SDF.

Counterpart of ``sdfkit_tpu/ops/grid.py`` (the port's ``ops`` is the callback
namespace ``ops.py``, so the grid functions live here). Reference semantics:
the SDF is evaluated at **cell centres** ``min + (i + 0.5) * D`` with
``D = (max - min) / n``; ``clip_to_bounds`` overwrites the 6 outer wall layers
with the positive "outside" value ``size.x / nx`` so meshes close at volume
edges. The whole grid is one plain torch evaluation over an ``(nx, ny, nz)``
structure-of-arrays grid on the scene's device; ``parallel.voxelize_sharded``
evaluates z-bricks of it through the same functions, so its values are the
whole grid's bit for bit.
"""

from __future__ import annotations

import torch

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.device import resolve
from sdfkit_tpu_torch.mesh.voxels import Voxels
from sdfkit_tpu_torch.sdf.expr import SdfExpr, scene_device
from sdfkit_tpu_torch.utils.v3 import V3


def _bound(v, device) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.shape != (3,):
        raise ValueError(f"a grid bound must have 3 components, got shape {tuple(v.shape)}")
    return v


def cell_centers(vmin, vmax, nx: int, ny: int, nz: int, device=None, z0: int = 0,
                 z1: int | None = None) -> V3:
    """Cell-centre sample positions as a structure-of-arrays (nx, ny, nz)
    grid, on ``device``: by default the bounds' own when they are tensors,
    else the package's default device. ``z0`` / ``z1`` keep the layers
    ``z0 <= z < z1`` of the z axis (all by default): a brick's positions are
    the whole grid's at those layers, bit for bit."""
    if device is None and isinstance(vmin, torch.Tensor):
        device = vmin.device
    device = resolve(device)
    vmin, vmax = _bound(vmin, device), _bound(vmax, device)
    d = (vmax - vmin) / torch.tensor([nx, ny, nz], dtype=torch.float32, device=vmin.device)

    def axis(k, start, stop):
        i = torch.arange(start, stop, dtype=torch.float32, device=vmin.device)
        return vmin[k] + (i + 0.5) * d[k]

    z1 = nz if z1 is None else z1
    shape = (nx, ny, z1 - z0)
    return V3(
        axis(0, 0, nx)[:, None, None].expand(shape),
        axis(1, 0, ny)[None, :, None].expand(shape),
        axis(2, z0, z1)[None, None, :].expand(shape),
    )


def clip_values_to_bounds(values: torch.Tensor, vmin, vmax, z0: int = 0,
                          nz: int | None = None) -> torch.Tensor:
    """A copy of ``values`` whose 6 outer wall layers hold the positive
    outside value ``(max.x - min.x) / nx``. ``values`` may be the layers from
    ``z0`` of a grid of ``nz`` layers (the whole grid by default): the z walls
    are the grid's first and last layers."""
    nx, _, nzb = values.shape
    nz = nzb if nz is None else nz
    outside = (_bound(vmax, values.device)[0] - _bound(vmin, values.device)[0]) / nx
    z = torch.arange(z0, z0 + nzb, device=values.device)
    interior = torch.zeros_like(values, dtype=torch.bool)
    interior[1:-1, 1:-1, :] = ((z >= 1) & (z < nz - 1))[None, None, :]
    return torch.where(interior, values, outside.to(values.dtype))


def sample_layers(sdf: SdfExpr, vmin, vmax, nx: int, ny: int, nz: int, z0: int, z1: int,
                  clip_to_bounds: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, colors) of the layers ``z0 <= z < z1`` of the grid
    ``voxelize`` samples, on the scene's device: its values bit for bit."""
    device = scene_device(sdf)
    vmin, vmax = _bound(vmin, device), _bound(vmax, device)
    p = cell_centers(vmin, vmax, int(nx), int(ny), int(nz), z0=int(z0), z1=int(z1))
    color, dist = sdf.eval(p)
    colors = torch.stack([ops.broadcast_to(c, dist.shape) for c in (color.x, color.y, color.z)],
                         dim=-1)
    values = clip_values_to_bounds(dist, vmin, vmax, int(z0), int(nz)) if clip_to_bounds else dist
    return values, colors


def voxelize(sdf: SdfExpr, vmin, vmax, nx: int, ny: int, nz: int,
             clip_to_bounds: bool = True) -> Voxels:
    """Sample ``sdf`` on a dense grid, on the scene's device."""
    device = scene_device(sdf)
    vmin, vmax = _bound(vmin, device), _bound(vmax, device)
    values, colors = sample_layers(sdf, vmin, vmax, nx, ny, nz, 0, nz, clip_to_bounds)
    return Voxels(values=values, colors=colors, vmin=vmin, vmax=vmax)
