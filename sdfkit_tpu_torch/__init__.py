"""sdfkit_tpu_torch -- the PyTorch and CUDA port of sdfkit_tpu.

What exists so far is the forward render: the SDF expression DSL (nodes are
``nn.Module``s), the scene compiler, the plain PyTorch sphere tracer and the
hand-written CUDA forward kernel for Hopper. The package imports torch and
numpy, never JAX.
"""

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.render.raymarch import RayMarcher, RenderConfig, render, render_depth
from sdfkit_tpu_torch.sdf import expr as sdf
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
    "Plane",
    "RayMarcher",
    "RenderConfig",
    "SdfExpr",
    "Sphere",
    "Torus",
    "V3",
    "box",
    "capsule",
    "cylinder",
    "leaves",
    "load_leaves",
    "look_at",
    "ops",
    "perspective_fov",
    "plane",
    "plane_xy",
    "plane_xz",
    "render",
    "render_depth",
    "sdf",
    "solid",
    "sphere",
    "torus",
    "union",
]
