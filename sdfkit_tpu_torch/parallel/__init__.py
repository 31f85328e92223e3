"""The paths split over ranks (``sdfkit_tpu/parallel``): 1-D decompositions
over a :class:`Mesh` of processes, one device each, on ``torch.distributed``:
image row bands (``render_sharded``, ``train_step_sharded``,
``fit(mesh=)``, the tiles of ``render_tiles_resumable``) and voxel z-bricks
with halos (``voxelize_sharded``, ``create_mesh_sharded``)."""

from sdfkit_tpu_torch.parallel.distributed import Mesh, initialize, make_mesh
from sdfkit_tpu_torch.parallel.elastic import render_tiles_resumable
from sdfkit_tpu_torch.parallel.marching import create_mesh_sharded
from sdfkit_tpu_torch.parallel.train import (
    VoxelBricks,
    render_sharded,
    train_step_sharded,
    voxelize_sharded,
)

__all__ = [
    "Mesh",
    "VoxelBricks",
    "create_mesh_sharded",
    "initialize",
    "make_mesh",
    "render_sharded",
    "render_tiles_resumable",
    "train_step_sharded",
    "voxelize_sharded",
]
