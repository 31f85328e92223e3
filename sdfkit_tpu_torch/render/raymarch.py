"""Sphere-tracing renderer: the plain PyTorch path and the backend choice.

Counterpart of ``sdfkit_tpu/render/raymarch.py``, with the reference's
RayMarcher semantics:

* depth starts at ``near - 0.1``;
* a **fixed** number of march iterations, with no early exit and no hit
  threshold (misses keep accumulating depth far past the far plane);
* the diffuse color is the RGB of the *last* march sample;
* normals from 6-tap central differences with eps 1e-5;
* one point light at (5,5,10), Lambert ``max(dot(n,l),0)*diffuse + 0.1``;
* sky color (0.5, 0.75, 1.0) where ``depth > far``.

The functions here are the plain version of the CUDA kernel in
``render/cuda/raymarch_kernel.py``: the same math in torch ops, differentiable
by autograd. ``RayMarcher(backend="auto")`` takes the kernel when the scene's
parameters are on CUDA and this path when they are on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.sdf.expr import SdfExpr, scene_device
from sdfkit_tpu_torch.utils.camera import camera_rays, default_view, look_at
from sdfkit_tpu_torch.utils.spans import span
from sdfkit_tpu_torch.utils.v3 import V3

DEFAULT_NEAR = 1.0
DEFAULT_FAR = 100.0
DEFAULT_VFOV_DEGREES = 60.0
DEFAULT_DEPTH_ITERATIONS = 40
GRAD_OFFSET = 1e-5
LIGHT_POSITION = (5.0, 5.0, 10.0)
AMBIENT = 0.1
SKY_COLOR = (0.5, 0.75, 1.0)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the reference's RayMarcher properties)."""

    width: int
    height: int
    vfov_degrees: float = DEFAULT_VFOV_DEGREES
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    depth_iterations: int = DEFAULT_DEPTH_ITERATIONS


def _march(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig, want_color: bool):
    """Fixed-iteration sphere trace. Returns (depth, last-sample color)."""
    depth = torch.full_like(ro.x, cfg.near - 0.1)
    n = cfg.depth_iterations
    for _ in range(n if not want_color else n - 1):
        depth = depth + sdf.distance(ro + rd * depth)
    if not want_color:
        return depth, None
    color, dist = sdf.eval(ro + rd * depth)
    color = V3(*(ops.broadcast_to(c, dist.shape) for c in (color.x, color.y, color.z)))
    return depth + dist, color


def march_history(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> torch.Tensor:
    """The (depth_iterations, ...) depth history of the march: row ``i`` is
    the depth before step ``i`` (row 0 is ``near - 0.1``), so the last row is
    the depth before the final step. The plain version of what the forward
    kernel's depth-history variant writes for the backward."""
    depth = torch.full_like(ro.x, cfg.near - 0.1)
    rows = [depth]
    for _ in range(cfg.depth_iterations - 1):
        depth = depth + sdf.distance(ro + rd * depth)
        rows.append(depth)
    return torch.stack(rows)


def settled_steps(history: torch.Tensor) -> torch.Tensor:
    """Per ray of a (depth_iterations, rays) depth history, the first march
    step that left the depth bit for bit where it was (row ``s + 1`` equal to
    row ``s`` in every bit), or ``depth_iterations - 1`` where none did. A
    step is a function of the depth's bits, so every later row equals row
    ``s + 1``: the forward kernels leave the march there (``march_depth`` in
    ``csrc/raymarch_fwd.cuh``). A NaN never settles, as there."""
    b = history.contiguous().view(torch.int32)
    same = (b[1:] == b[:-1]) & ~torch.isnan(history[1:])
    first = same.int().argmax(0)
    return torch.where(same.any(0), first, torch.full_like(first, history.shape[0] - 1))


def warp_march_steps(steps: torch.Tensor, iterations: int, every: int,
                     warp: int = 32) -> torch.Tensor:
    """The march steps each warp of ``warp`` consecutive rays runs when it
    tests every ``every`` steps whether all its rays have settled: a ray
    needs ``settled_steps + 1`` steps (the one that shows it), a warp its
    slowest ray's, rounded up to a test, and at most ``iterations - 1``."""
    need = torch.clamp(steps + 1, max=iterations - 1)
    pad = (-need.numel()) % warp
    if pad:
        need = torch.cat([need, need.new_zeros(pad)])
    slowest = need.view(-1, warp).amax(1)
    return torch.clamp((slowest + every - 1) // every * every, max=iterations - 1)


def _distance_gradient(sdf: SdfExpr, p: V3) -> V3:
    """6-tap central-difference gradient with the reference's eps (not
    autograd: pixel parity needs the same estimator)."""
    e = GRAD_OFFSET

    def d(dx, dy, dz):
        return sdf.distance(V3(p.x + dx, p.y + dy, p.z + dz))

    return V3(
        d(e, 0.0, 0.0) - d(-e, 0.0, 0.0),
        d(0.0, e, 0.0) - d(0.0, -e, 0.0),
        d(0.0, 0.0, e) - d(0.0, 0.0, -e),
    )


def render_depth_rays(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> torch.Tensor:
    depth, _ = _march(sdf, ro, rd, cfg, want_color=False)
    return depth


def render_rays(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> torch.Tensor:
    """An (..., 3) RGB image for the given rays."""
    depth, diffuse = _march(sdf, ro, rd, cfg, want_color=True)
    bg = depth > cfg.far
    # Shade miss pixels at a benign depth: their accumulated depth is ~2^n
    # sensitive to the parameters, and a masked-out branch fed with it would
    # leak inf*0 = NaN into the backward. Hit pixels are untouched.
    shade_depth = torch.where(bg, torch.full_like(depth, cfg.near), depth)
    surface = ro + rd * shade_depth
    normal = _distance_gradient(sdf, surface).safe_normalize()
    light = (V3(*LIGHT_POSITION) - surface).safe_normalize()
    # maximum, not clamp_min: on a tie it halves the cotangent, as jnp.maximum
    # and the backward kernel do (clamp_min would pass all of it).
    lambert = ops.maximum(normal.dot(light), 0.0)
    lighting = diffuse * lambert + AMBIENT
    sky = V3(*(torch.full_like(depth, c) for c in SKY_COLOR))
    return lighting.where(~bg, sky).to_array()


def render_image_torch(sdf: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W, 3) RGB on the plain path."""
    ro, rd = camera_rays(cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far)
    return render_rays(sdf, ro, rd, cfg)


def render_depth_image_torch(sdf: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W) depth on the plain path."""
    ro, rd = camera_rays(cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far)
    return render_depth_rays(sdf, ro, rd, cfg)


BACKENDS = ("auto", "kernel", "torch")


def _on_cuda(sdf: SdfExpr) -> bool:
    """Whether the scene's parameters are on a CUDA device, where the kernels run."""
    return scene_device(sdf).type == "cuda"


def resolve_backend(backend: str, sdf: SdfExpr) -> str:
    """'kernel' or 'torch' for a scene: 'auto' takes the CUDA kernels when the
    scene's parameters are on CUDA and the plain path on the CPU, and 'kernel'
    on a CPU scene raises. The kernels take a scene of any size (a library
    whose parameters do not fit in constant memory reads them from device
    memory, ``csrc/raymarch_uniforms.cuh``). One rule for ``RayMarcher`` (and
    so for ``render`` and ``fit``, which render through it) and the tile
    renderer (the JAX package's ``resolve_shard_backend``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    on_cuda = _on_cuda(sdf)
    if backend == "auto":
        return "kernel" if on_cuda else "torch"
    if backend == "kernel" and not on_cuda:
        raise ValueError(
            f"backend='kernel' needs the scene on a CUDA device, not {scene_device(sdf)}")
    return backend


class RayMarcher:
    """Object-style API mirroring the reference RayMarcher.

    ``render()`` returns an (H, W, 3) RGB tensor and ``render_depth()`` an
    (H, W) depth tensor, on the scene's device. The device is that of the
    scene's parameters; the view must be on it too, or the call raises.

    backend: 'kernel' = the hand-written CUDA kernel (CUDA scenes only),
    'torch' = the plain path (any device, differentiable by autograd),
    'auto' = the kernel for a scene on CUDA, the plain path on the CPU.
    The kernel rounds differently from the plain path (FMA contraction
    compounds over the 40 steps), so pixel comparisons against goldens
    should use the plain path or the distributional contract of
    ``tests/test_goldens.py``.
    """

    def __init__(self, width: int, height: int, sdf: SdfExpr, view=None,
                 vfov_degrees: float = DEFAULT_VFOV_DEGREES, near: float = DEFAULT_NEAR,
                 far: float = DEFAULT_FAR, depth_iterations: int = DEFAULT_DEPTH_ITERATIONS,
                 backend: str = "auto"):
        self.backend = resolve_backend(backend, sdf)
        self.device = scene_device(sdf)
        self.sdf = sdf
        self.view = default_view(self.device) if view is None else self._check_view(view)
        self.config = RenderConfig(
            width=int(width), height=int(height), vfov_degrees=float(vfov_degrees),
            near=float(near), far=float(far), depth_iterations=int(depth_iterations),
        )

    def _check_view(self, view) -> torch.Tensor:
        if not isinstance(view, torch.Tensor):
            view = torch.as_tensor(view, dtype=torch.float32, device=self.device)
        if view.device != self.device:
            raise ValueError(f"the view is on {view.device} but the scene is on {self.device}")
        if view.shape != (4, 4) or view.dtype != torch.float32:
            raise ValueError(f"the view must be a (4, 4) float32 matrix, got {tuple(view.shape)} {view.dtype}")
        return view

    def _view(self, camera):
        return self.view if camera is None else self._check_view(camera)

    def render(self, camera=None) -> torch.Tensor:
        with span("sdf.frame", top=True):
            view = self._view(camera)
            if self.backend == "kernel":
                from sdfkit_tpu_torch.render.cuda.raymarch_kernel import render_image_kernel

                return render_image_kernel(self.sdf, view, self.config)
            return render_image_torch(self.sdf, view, self.config)

    def render_depth(self, camera=None) -> torch.Tensor:
        with span("sdf.frame", top=True):
            view = self._view(camera)
            if self.backend == "kernel":
                from sdfkit_tpu_torch.render.cuda.raymarch_kernel import render_depth_image_kernel

                return render_depth_image_kernel(self.sdf, view, self.config)
            return render_depth_image_torch(self.sdf, view, self.config)


def render(sdf: SdfExpr, width: int, height: int, camera_position=None,
           camera_target=(0.0, 0.0, 0.0), camera_up=(0.0, 1.0, 0.0), view=None,
           **kwargs) -> torch.Tensor:
    """Functional entry point mirroring ``Sdf.ToImage``; the default view is
    made on the scene's device."""
    if view is None:
        device = scene_device(sdf)
        if camera_position is None:
            view = default_view(device)
        else:
            view = look_at(camera_position, camera_target, camera_up, device=device)
    return RayMarcher(width, height, sdf, view=view, **kwargs).render()


def render_depth(sdf: SdfExpr, width: int, height: int, view=None, **kwargs) -> torch.Tensor:
    if view is None:
        view = default_view(scene_device(sdf))
    return RayMarcher(width, height, sdf, view=view, **kwargs).render_depth()
