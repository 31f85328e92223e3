"""Volumes, meshes and marching cubes (``sdfkit_tpu/mesh``)."""

from sdfkit_tpu_torch.mesh.mesh import Mesh
from sdfkit_tpu_torch.mesh.voxels import Voxels

__all__ = ["Mesh", "Voxels"]
