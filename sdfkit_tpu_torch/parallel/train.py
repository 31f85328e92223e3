"""Rendering, differentiable fitting and grid sampling split over the ranks of a mesh.

Counterpart of ``sdfkit_tpu/parallel/train.py``. The reference's only
parallelism is CPU threads over image row bands and point batches; the JAX
package lifts the same 1-D decomposition onto a device mesh with
``shard_map``. Here each rank is a process (``distributed.py``):

* **Row bands.** An image of ``H`` rows is cut into bands of
  ``rows_local = ceil(H / n)`` rows; rank ``r`` owns rows
  ``[r * rows_local, min(H, (r + 1) * rows_local))``. The kernel backend runs
  the image kernels on the band (``render_rows_kernel`` from flat pixel
  ``r * rows_local * W``); the torch backend renders the band's slice of the
  frame's camera rays. A rank renders only its real rows: the kernels refuse
  a pixel range past the image (where the JAX package's Pallas kernel
  computes extrapolated rays for the last band), so the last band is padded
  after the render, for the gather, and the padding is cut off.
* **Gradients.** Each rank's loss is ``sum((band - target) ** 2) / (H W 3)``
  over its real rows; ``backward`` runs the image backward kernel once per
  band; one all-reduce sums every leaf's gradient and the loss, so every rank
  takes the same step.
* **z-bricks.** A grid of ``nz`` layers is cut into bricks of
  ``ceil(nz / n)`` layers. Each rank samples its own from its z offset
  through ``grid.sample_layers``, the arithmetic of ``grid.voxelize``, so the
  values are the whole grid's bit for bit at any rank count, and the bricks
  go to ``marching.create_mesh_sharded`` without a gather of the grid.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from sdfkit_tpu_torch.grid import _bound, sample_layers
from sdfkit_tpu_torch.mesh.voxels import Voxels
from sdfkit_tpu_torch.parallel.distributed import Mesh
from sdfkit_tpu_torch.render.raymarch import (
    RenderConfig,
    render_depth_rays,
    render_rays,
)
from sdfkit_tpu_torch.render.raymarch import resolve_backend as resolve_shard_backend
from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves, scene_device
from sdfkit_tpu_torch.utils.camera import camera_rays, default_view, inv_view_proj
from sdfkit_tpu_torch.utils.spans import span
from sdfkit_tpu_torch.utils.v3 import V3


def band_rows(mesh: Mesh, n_rows: int) -> tuple[int, int, int]:
    """(rows_local, first row, real rows) of this rank's band of ``n_rows``
    rows: bands of ``ceil(n_rows / n)`` rows in rank order, the last ones
    shorter or empty."""
    rows_local = -(-n_rows // mesh.size)
    r0 = mesh.rank * rows_local
    return rows_local, r0, max(0, min(n_rows, r0 + rows_local) - r0)


def row_renderer(sdf: SdfExpr, view: torch.Tensor, cfg: RenderConfig, backend: str,
                 depth_only: bool = False):
    """``render(r0, n_rows)``: rows ``[r0, r0 + n_rows)`` of the frame,
    (n_rows, W, 3) RGB or (n_rows, W) depth, differentiable in the scene.

    The kernel backend needs no ray arrays: the kernel makes a band's rays
    from its flat pixel offset, with the view scalars prepared once. The
    plain backend makes the frame's rays once and slices a band's rows, so
    band boundaries never change the ray math."""
    if backend == "kernel":
        from sdfkit_tpu_torch.render.cuda.raymarch_kernel import (
            render_depth_rows_kernel,
            render_rows_kernel,
        )

        fn = render_depth_rows_kernel if depth_only else render_rows_kernel
        with torch.no_grad():
            ivp, cam = inv_view_proj(view, cfg.width, cfg.height, cfg.vfov_degrees, cfg.near,
                                     cfg.far)
        return lambda r0, n_rows: fn(sdf, ivp, cam, r0 * cfg.width, cfg, n_rows)

    fn = render_depth_rays if depth_only else render_rays
    with torch.no_grad():
        ro, rd = camera_rays(cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far)

    def render(r0, n_rows):
        def rows(v: V3) -> V3:
            return V3(*(c[r0:r0 + n_rows] for c in (v.x, v.y, v.z)))

        return fn(sdf, rows(ro), rows(rd), cfg)

    return render


def gather_rows(mesh: Mesh, band: torch.Tensor, rows_local: int, n_rows: int) -> torch.Tensor:
    """Every rank's band, padded to ``rows_local`` rows for the all-gather,
    stacked in rank order and cut to ``n_rows`` rows."""
    pad = rows_local - band.shape[0]
    if pad:
        band = torch.cat([band, band.new_zeros((pad, *band.shape[1:]))])
    return torch.cat(mesh.all_gather(band))[:n_rows]


def render_rows_sharded(mesh: Mesh, render, r0: int, n_rows: int) -> torch.Tensor:
    """Rows ``[r0, r0 + n_rows)`` through ``render`` (a ``row_renderer``),
    split in bands over the mesh and gathered on every rank."""
    rows_local, b0, count = band_rows(mesh, n_rows)
    band = render(r0 + min(b0, n_rows), count)  # an empty band starts inside the image
    return gather_rows(mesh, band, rows_local, n_rows)


def _view(view, device) -> torch.Tensor:
    if view is None:
        return default_view(device)
    return torch.as_tensor(view, dtype=torch.float32, device=device)


def build_sharded_render(mesh: Mesh, sdf: SdfExpr, view: torch.Tensor, cfg: RenderConfig,
                         depth_only: bool = False, backend: str = "auto"):
    """The sharded render that ``render_sharded`` runs, as ``(fn, args)``:
    ``fn(*args)`` is the whole frame on every rank. A harness times the
    computation users run through it."""
    render = row_renderer(sdf, view, cfg, resolve_shard_backend(backend, sdf), depth_only)

    def fn():
        with torch.no_grad():
            return render_rows_sharded(mesh, render, 0, cfg.height)

    return fn, ()


def render_sharded(mesh: Mesh, sdf: SdfExpr, width: int, height: int, view=None,
                   depth_only: bool = False, backend: str = "auto", **cfg_kwargs):
    """The frame with its rows split over the mesh, on every rank: (H, W, 3)
    RGB or (H, W) depth. Each rank renders its band and one all-gather
    assembles the frame. ``backend``: 'kernel' (the CUDA image kernels on
    each band, a scene on CUDA), 'torch' (the plain path), 'auto' the kernel
    for a scene on CUDA (``render.raymarch.resolve_backend``). Equal bit for
    bit to the one-device frame of the same backend."""
    cfg = RenderConfig(width=int(width), height=int(height), **cfg_kwargs)
    view = _view(view, scene_device(sdf))
    fn, args = build_sharded_render(mesh, sdf, view, cfg, depth_only, backend)
    return fn(*args)


def band_loss_and_grads(mesh: Mesh, render, params, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the frame against ``target`` (H, W, 3), with
    this rank rendering its band through ``render`` (a ``row_renderer``):
    leaves every parameter's ``.grad`` the gradient summed over the ranks and
    returns the loss, the same on every rank. One all-reduce carries the
    gradients and the loss."""
    height, width = target.shape[:2]
    _, r0, count = band_rows(mesh, height)
    with span("sdf.fit.grads"):
        for p in params:
            p.grad = None
    loss = None
    if count:
        with span("sdf.fit.forward"):
            band = render(r0, count)
            loss = ((band - target[r0:r0 + count]) ** 2).sum() / (height * width * 3)
        with span("sdf.fit.backward"):
            loss.backward()
    with span("sdf.fit.grads"):
        parts = [torch.zeros_like(p).reshape(-1) if p.grad is None else p.grad.reshape(-1)
                 for p in params]
        parts.append(target.new_zeros(1) if loss is None else loss.detach().reshape(1))
        flat = mesh.all_reduce_sum(torch.cat(parts))
        i = 0
        for p in params:
            p.grad = flat[i:i + p.numel()].view_as(p).clone()
            i += p.numel()
    return flat[-1]


def _target(target, device) -> torch.Tensor:
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, dtype=np.float32))
    target = target.to(device=device, dtype=torch.float32)
    if target.ndim != 3 or target.shape[2] != 3:
        raise ValueError(f"the target must be an (H, W, 3) image, got {tuple(target.shape)}")
    return target


def train_step_sharded(mesh: Mesh, sdf: SdfExpr, target, view=None, lr: float = 1e-2,
                       backend: str = "auto", **cfg_kwargs):
    """One fitting step over the mesh: render the frame in row bands, take
    the mean squared error against ``target`` (H, W, 3), all-reduce the
    gradients, take one SGD step. Returns ``(new_sdf, loss)``: a new scene,
    the same on every rank (``sdf`` keeps its values), and the loss before
    the step. The low-level one-step primitive; the full loop (clipping,
    Adam, checkpoints) is ``fit(..., mesh=mesh)``."""
    backend = resolve_shard_backend(backend, sdf)
    new = copy.deepcopy(sdf)
    device = scene_device(new)
    target = _target(target, device)
    height, width = target.shape[:2]
    cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
    params = leaves(new)
    loss = band_loss_and_grads(mesh, row_renderer(new, _view(view, device), cfg, backend),
                               params, target)
    with torch.no_grad():
        for p in params:
            p.sub_(lr * p.grad)
            p.grad = None
    return new, loss


@dataclasses.dataclass(frozen=True)
class VoxelBricks:
    """This rank's z-brick of a grid sampled over a mesh.

    The grid has ``nz`` layers, cut into bricks of ``ceil(nz / mesh.size)``
    layers in rank order; ``values`` (nx, ny, k) and ``colors`` (nx, ny, k, 3)
    are its layers ``z0 <= z < z0 + k`` (``k`` is smaller, or 0, for the last
    ranks). ``create_mesh_sharded`` takes it as it is; ``gather`` assembles
    the whole ``Voxels`` on every rank."""

    mesh: Mesh
    values: torch.Tensor
    colors: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    z0: int
    nz: int

    @property
    def brick_layers(self) -> int:
        return -(-self.nz // self.mesh.size)

    def gather(self) -> Voxels:
        """The whole grid on every rank (one all-gather of the bricks)."""
        packed = torch.cat([self.values[..., None], self.colors], dim=-1)
        pad = self.brick_layers - packed.shape[2]
        if pad:
            packed = torch.cat([packed, packed.new_zeros((*packed.shape[:2], pad, 4))], dim=2)
        whole = torch.cat(self.mesh.all_gather(packed), dim=2)[:, :, :self.nz]
        return Voxels(values=whole[..., 0].contiguous(), colors=whole[..., 1:].contiguous(),
                      vmin=self.vmin, vmax=self.vmax)


def voxelize_sharded(mesh: Mesh, sdf: SdfExpr, vmin, vmax, nx: int, ny: int, nz: int,
                     clip_to_bounds: bool = True) -> VoxelBricks:
    """Dense grid sampling with z-bricks split over the mesh: this rank's
    brick, sampled from its own cell centres (the z axis, not x, so that the
    bricks are those ``create_mesh_sharded`` meshes). The values are
    ``grid.voxelize``'s bit for bit at any rank count; clipping uses the whole
    grid's bounds."""
    device = scene_device(sdf)
    vmin, vmax = _bound(vmin, device), _bound(vmax, device)
    nx, ny, nz = int(nx), int(ny), int(nz)
    b = -(-nz // mesh.size)
    z0 = min(nz, mesh.rank * b)
    z1 = min(nz, z0 + b)
    with torch.no_grad():
        values, colors = sample_layers(sdf, vmin, vmax, nx, ny, nz, z0, z1, clip_to_bounds)
    return VoxelBricks(mesh=mesh, values=values, colors=colors, vmin=vmin, vmax=vmax, z0=z0,
                       nz=nz)
