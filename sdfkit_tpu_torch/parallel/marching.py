"""Marching cubes with the dense phase split over the ranks as z-bricks with halos.

Counterpart of ``sdfkit_tpu/parallel/marching.py``. The reference meshes
strictly in sequence; its only dependency across a partition is the cell
adjacency at a brick's seam, which a ``step``-layer halo satisfies. Each rank
holds a z-brick of the value grid (``ceil(nz / n)`` layers, the bricks of
``train.voxelize_sharded``), and owns the cells whose base layer lies in its
brick:

1. **Halo.** One all-gather of every brick's first ``min(step, brick)``
   layers (a 256x256 slab at 256^3); a rank appends what follows its brick,
   and the last rank pads (its cells never read past the grid).
2. **Dense phase, per brick on its device.** The corner-sign classify of
   ``mesh/marching_cubes.py``, ``torch.nonzero`` for the active cells in
   (z, y, x) order, and the eight corner values of each.
3. **The cell stream.** One all-gather of the active cells' ids and corner
   values. Bricks own ascending z ranges, so the concatenation in rank order
   is the one-device cell stream. Every rank builds the unique corner points'
   values from it (a scatter into the point grid) and runs the one-device
   sparse phase: ``native.McSparse`` on the host, then the colour blends.
   The case bytes the JAX package also gathers are not sent: the C++ index
   takes each cell's case from its corner values.
4. **Colour blends.** They read the values and colours at the vertices'
   edge endpoints and corners, which lie in any brick. Each rank reads those
   in its own brick, one all-gather collects them, and each id keeps its
   owner's reading: a copy, so the blends' float32 arithmetic runs on the
   same numbers as on one device. The colour grid is never gathered (at
   256^3 it is 201 MB; the readings are about 16 bytes a vertex and rank).

The mesh is array-equal to ``create_mesh`` on the whole grid at any rank
count, on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from sdfkit_tpu_torch.mesh.marching_cubes import (
    _CORNERS,
    _classify_slab,
    _empty_mesh,
    _host_bounds,
    _point_mask,
    _visited,
    sparse_phase,
)
from sdfkit_tpu_torch.mesh.mesh import Mesh as TriMesh
from sdfkit_tpu_torch.parallel.distributed import Mesh
from sdfkit_tpu_torch.parallel.train import VoxelBricks


def _brick_layout(nz: int, step: int, n: int) -> tuple[int, int]:
    """(visited cell layers, z layers per brick) of a grid of ``nz`` layers
    over ``n`` ranks."""
    return _visited(nz, step), -(-nz // n)


def _pad_z(arr: torch.Tensor, layers: int) -> torch.Tensor:
    """Axis 2 zero-padded (or cut) to ``layers``: padding no real cell reads."""
    pad = layers - arr.shape[2]
    if pad <= 0:
        return arr[:, :, :layers]
    return torch.cat([arr, arr.new_zeros((*arr.shape[:2], pad, *arr.shape[3:]))], dim=2)


def _halo_exchange(mesh: Mesh, brick: torch.Tensor, step: int) -> torch.Tensor:
    """The brick (nx, ny, b) with the ``step`` z-layers that follow it
    appended: one all-gather of every brick's first ``min(step, b)`` layers,
    of which this rank takes its successors' (several bricks' when a brick is
    thinner than ``step``); the last rank pads."""
    k = min(step, brick.shape[2])
    pieces = mesh.all_gather(brick[:, :, :k].contiguous())[mesh.rank + 1:]
    halo = torch.cat(pieces, dim=2) if pieces else brick[:, :, :0]
    return torch.cat([brick, _pad_z(halo, step)], dim=2)


def _classify_brick(ext: torch.Tensor, iso: float, z0: int, b: int, step: int, lx: int,
                    ly: int, lz: int):
    """The active cells whose base layer lies in this brick (grid layers
    ``[z0, z0 + b)``): their flat (z, y, x) ids over the whole grid, and their
    eight corner values (8, k) in ``_CORNERS`` order. ``ext`` is the brick
    with its halo."""
    c0 = -(-z0 // step)
    m = min(lz, -(-(z0 + b) // step)) - c0
    if m <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=ext.device),
                ext.new_zeros((8, 0)))
    zoff = c0 * step - z0
    mask = _classify_slab(ext, iso, zoff, step, lx, ly, m)
    idx = torch.nonzero(mask.reshape(-1)).squeeze(1)
    cx = (idx % lx) * step
    cy = ((idx // lx) % ly) * step
    cz = (idx // (lx * ly)) * step + zoff
    v8 = torch.stack([ext[cx + dx * step, cy + dy * step, cz + dz * step]
                      for dx, dy, dz in _CORNERS])
    return idx + c0 * lx * ly, v8


def _gather_cells(mesh: Mesh, ids: torch.Tensor, v8: torch.Tensor):
    """Every rank's active ids and corner values, concatenated in rank order
    (one all-gather of a small count, one of the cells as int32 words)."""
    counts = [int(c) for c in mesh.all_gather(ids.new_tensor([ids.numel()]))]
    cap = max(counts)
    if cap == 0:
        return ids, v8
    words = torch.cat([ids.view(torch.int32).view(-1, 2), v8.t().contiguous().view(torch.int32)],
                      dim=1)
    words = torch.cat([words, words.new_zeros((cap - words.shape[0], 10))])
    cells = torch.cat([w[:c] for w, c in zip(mesh.all_gather(words), counts)])
    return (cells[:, :2].contiguous().view(torch.int64).view(-1),
            cells[:, 2:].contiguous().view(torch.float32).t())


def _point_values(active: torch.Tensor, v8: torch.Tensor, lx: int, ly: int,
                  lz: int) -> torch.Tensor:
    """The unique corner points' values in ascending point id, what the
    one-device dense phase takes from the whole grid: the active cells' corner
    values scattered into the (lz+1, ly+1, lx+1) point grid (a point shared by
    cells gets the same value from each), read under the point mask."""
    cx, cy, cz = active % lx, (active // lx) % ly, active // (lx * ly)
    mask = torch.zeros(lz * ly * lx, dtype=torch.bool, device=active.device)
    mask[active] = True
    points = torch.empty((lz + 1) * (ly + 1) * (lx + 1), dtype=torch.float32,
                         device=active.device)
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        points[((cz + dz) * (ly + 1) + cy + dy) * (lx + 1) + cx + dx] = v8[k]
    return points[_point_mask(mask.view(lz, ly, lx)).reshape(-1)]


def _brick_reader(mesh: Mesh, values: torch.Tensor, colors: torch.Tensor, z0: int, b: int,
                  nz: int):
    """``read(ids) -> (values, colours)`` at flat ids of the whole (nx, ny,
    nz) grid, from the bricks: each rank reads the ids in its real layers
    ``values`` / ``colors`` (from grid layer ``z0``), one all-gather collects
    the readings, and each id keeps its owner's (rank ``z // b``)."""
    k = values.shape[2]
    local = torch.cat([values[..., None], colors], dim=-1).reshape(-1, 4)

    def read(ids):
        z, xy = ids % nz, ids // nz
        owner = torch.div(z, b, rounding_mode="floor")
        mine = owner == mesh.rank
        got = torch.zeros((ids.numel(), 4), dtype=torch.float32, device=ids.device)
        if k:
            got[mine] = local[xy[mine] * k + (z[mine] - z0)]
        readings = torch.stack(mesh.all_gather(got))
        out = readings[owner, torch.arange(ids.numel(), device=ids.device)]
        return out[:, 0].contiguous(), out[:, 1:].contiguous()

    return read


def create_mesh_sharded(mesh: Mesh, voxels, iso_value: float = 0.0, step: int = 1,
                        progress=None) -> TriMesh:
    """The iso-surface mesh with the dense phase split over ``mesh`` in
    z-bricks: ``create_mesh``'s semantics and its mesh, array for array, at
    any rank count, on every rank.

    ``voxels``: this rank's ``VoxelBricks`` (from ``voxelize_sharded`` on
    the same mesh), or a whole ``Voxels`` that every rank holds, of which
    each rank meshes its brick. ``progress(fraction)`` is called at 0 and 1."""
    with torch.no_grad():
        return _create_mesh_sharded(mesh, voxels, iso_value, int(step), progress)


def _create_mesh_sharded(mesh, voxels, iso_value, step, progress):
    iso = float(np.float32(iso_value))
    bricks = isinstance(voxels, VoxelBricks)
    if bricks and (voxels.mesh.size, voxels.mesh.rank) != (mesh.size, mesh.rank):
        raise ValueError(f"bricks of rank {voxels.mesh.rank} of {voxels.mesh.size} handed to "
                         f"rank {mesh.rank} of {mesh.size}")
    nz = voxels.nz if bricks else voxels.values.shape[2]
    lz, b = _brick_layout(nz, step, mesh.size)
    z0 = mesh.rank * b
    values, colors = voxels.values, voxels.colors
    if not bricks:  # every rank holds the grid: this rank meshes its brick
        values, colors = values[:, :, z0:z0 + b], colors[:, :, z0:z0 + b]
    values = values.detach().to(torch.float32)
    colors = colors.detach().to(torch.float32)
    nx, ny = values.shape[:2]
    lx, ly = _visited(nx, step), _visited(ny, step)

    if progress is not None:
        progress(0.0)
    if lx == 0 or ly == 0 or lz == 0:
        if progress is not None:
            progress(1.0)
        return _empty_mesh()
    if nx * ny * nz >= 2**31:
        raise NotImplementedError("the colour blends' flat grid ids are int32: a grid of "
                                  f"{nx * ny * nz} samples needs int64 ids")
    size_center = _host_bounds(voxels.vmin, voxels.vmax)

    ext = _halo_exchange(mesh, _pad_z(values, b), step)
    ids, v8 = _classify_brick(ext, iso, z0, b, step, lx, ly, lz)
    del ext
    active, v8 = _gather_cells(mesh, ids, v8)
    if active.numel() == 0:
        if progress is not None:
            progress(1.0)
        return _empty_mesh()
    pvals = _point_values(active, v8, lx, ly, lz)
    tri = sparse_phase(active, pvals, (nx, ny, nz), step, iso, size_center,
                       _brick_reader(mesh, values, colors, z0, b, nz), values.device)
    if progress is not None:
        progress(1.0)
    return tri
