"""sdfkit_tpu_torch -- the PyTorch and CUDA port of sdfkit_tpu.

What exists so far is the render and its gradient: the SDF expression DSL
(nodes are ``nn.Module``s), the scene compiler and its adjoint, the plain
PyTorch sphere tracer, the hand-written CUDA forward and backward kernels for
Hopper, and image-loss fitting (``fit``) on top of them. The package imports
torch and numpy, never JAX.

Scenes and views are made on the card by default; ask for the CPU with
``set_default_device("cpu")``, ``use_device("cpu")`` or ``device="cpu"`` on a
factory (see ``sdfkit_tpu_torch.device``).
"""

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.device import default_device, set_default_device, use_device
from sdfkit_tpu_torch.fit import FitResult, fit
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
    "FitResult",
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
    "default_device",
    "fit",
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
    "set_default_device",
    "solid",
    "sphere",
    "torus",
    "union",
    "use_device",
]
