"""sdfkit_tpu_torch -- the PyTorch and CUDA port of sdfkit_tpu.

What exists so far: the SDF expression DSL (nodes are ``nn.Module``s), the
scene compiler and its adjoint, the plain PyTorch sphere tracer, the
hand-written CUDA kernels for Hopper (image and ray-batch render, forward
and backward), image-loss fitting (``fit``), resumable tile rendering
(``parallel``), batched sampling (``sample``) and voxelization (``voxelize``,
``Voxels``), MC33 marching cubes (``create_mesh``, ``Voxels.to_mesh``,
``SdfExpr.to_mesh``; the dense phase on the volume's device, the sparse
phase in C++ built with g++ at first use) with OBJ export (``Mesh``), and
exact nearest-neighbour search and ICP registration
(``IterativeClosestPoint``, ``register_points_torch``,
``global_register_points``). The package imports torch and numpy, never JAX.

Scenes and views are made on the card by default; ask for the CPU with
``set_default_device("cpu")``, ``use_device("cpu")`` or ``device="cpu"`` on a
factory (see ``sdfkit_tpu_torch.device``).
"""

from sdfkit_tpu_torch import ops, parallel
from sdfkit_tpu_torch.device import default_device, set_default_device, use_device
from sdfkit_tpu_torch.fit import FitResult, fit
from sdfkit_tpu_torch.grid import voxelize
from sdfkit_tpu_torch.mesh import Mesh, Voxels
from sdfkit_tpu_torch.mesh.marching_cubes import create_mesh
from sdfkit_tpu_torch.registration.icp import (
    GridNN,
    IterativeClosestPoint,
    NearestNeighbors,
    global_register_points,
    nearest_neighbors,
    register_points_torch,
)
from sdfkit_tpu_torch.render.raymarch import RayMarcher, RenderConfig, render, render_depth
from sdfkit_tpu_torch.sdf import expr as sdf
from sdfkit_tpu_torch.sdf.sample import sample
from sdfkit_tpu_torch.sdf.expr import (
    Box,
    Capsule,
    Cylinder,
    Plane,
    SdfExpr,
    Sphere,
    Torus,
    box,
    capsule,
    cylinder,
    leaves,
    load_leaves,
    plane,
    plane_xy,
    plane_xz,
    solid,
    sphere,
    torus,
    union,
)
from sdfkit_tpu_torch.utils.camera import look_at, perspective_fov
from sdfkit_tpu_torch.utils.v3 import V3

__version__ = "0.1.0"

__all__ = [
    "Box",
    "Capsule",
    "Cylinder",
    "FitResult",
    "GridNN",
    "IterativeClosestPoint",
    "Mesh",
    "NearestNeighbors",
    "Plane",
    "RayMarcher",
    "RenderConfig",
    "SdfExpr",
    "Sphere",
    "Torus",
    "V3",
    "Voxels",
    "box",
    "capsule",
    "create_mesh",
    "cylinder",
    "default_device",
    "fit",
    "global_register_points",
    "leaves",
    "load_leaves",
    "look_at",
    "nearest_neighbors",
    "ops",
    "parallel",
    "perspective_fov",
    "plane",
    "plane_xy",
    "plane_xz",
    "register_points_torch",
    "render",
    "render_depth",
    "sample",
    "sdf",
    "set_default_device",
    "solid",
    "sphere",
    "torus",
    "union",
    "use_device",
    "voxelize",
]
