"""Volumes and meshes (``sdfkit_tpu/mesh``). Marching cubes is not ported yet."""

from sdfkit_tpu_torch.mesh.mesh import Mesh
from sdfkit_tpu_torch.mesh.voxels import Voxels

__all__ = ["Mesh", "Voxels"]
