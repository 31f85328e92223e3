"""The forward sphere-trace CUDA kernel and its PyTorch wrapper.

Replaces ``sdfkit_tpu/render/pallas/raymarch_kernel.py``
``_pallas_render_image_flat`` (reached through ``render_image_fused`` and
``render_depth_image_fused``). Its plain version is
``render/raymarch.py``'s ``render_image_torch`` / ``render_depth_image_torch``.

What bounds it on an H100: arithmetic -- about 46 scene evaluations per
pixel, and 12 bytes written per pixel (RGB). The design keeps the whole march
in registers: one thread per pixel makes its ray from the pixel index and 19
view scalars, and reads nothing else from device memory but the flat
parameter buffer. The kernel source is ``csrc/raymarch_fwd.cuh`` (per pixel) and
``csrc/raymarch_fwd.cu`` (the launch); the scene body comes from the scene
compiler and the build from ``build.py``.

``LAUNCHES`` counts kernel launches, so a run can show that its frames went
through the kernel. The wrapper takes CUDA float32 tensors only and raises
on anything else; the CPU is served by ``RayMarcher(backend="auto")``
choosing the plain path. The backward is not ported yet: differentiating
through the kernel raises, and there is no fallback to the plain path.
"""

from __future__ import annotations

import torch

from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params
from sdfkit_tpu_torch.sdf.expr import SdfExpr
from sdfkit_tpu_torch.utils.camera import inv_view_proj

LAUNCHES = 0


def view19(view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """inverse(view @ proj) row-major (16) then the camera position (3), in
    float32 on the view's device -- the host-side prep of the TPU kernel
    (``_view_to_ivp_cam``)."""
    ivp, cam = inv_view_proj(view, cfg.width, cfg.height, cfg.vfov_degrees, cfg.near, cfg.far)
    return torch.cat([ivp.reshape(16), cam.reshape(3)]).contiguous()


def _check(name: str, t: torch.Tensor, shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the CUDA kernel takes CUDA tensors only")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def launch(lib: build.KernelLib, params: torch.Tensor, v19: torch.Tensor, cfg: RenderConfig,
           want_color: bool, pix0: int = 0, local_npix: int | None = None) -> torch.Tensor:
    """Run the kernel over ``local_npix`` pixels from flat pixel ``pix0``:
    (local_npix, 3) RGB or (local_npix,) depth, on the current stream."""
    global LAUNCHES
    npix = cfg.width * cfg.height
    if local_npix is None:
        local_npix = npix
    if npix >= 2**31 or not 0 <= pix0 <= pix0 + local_npix <= npix:
        raise ValueError(f"pixel range [{pix0}, {pix0 + local_npix}) of a {npix}-pixel image")
    _check("params", params)
    _check("view19", v19, (19,))
    if v19.device != params.device:
        raise ValueError(f"the view is on {v19.device} but the scene is on {params.device}")
    out = torch.empty(
        (local_npix, 3) if want_color else (local_npix,), dtype=torch.float32,
        device=params.device,
    )
    if local_npix == 0:
        return out
    with torch.cuda.device(params.device):
        rc = lib.launch(
            params.data_ptr(), v19.data_ptr(), cfg.width, cfg.height, pix0, local_npix,
            cfg.depth_iterations, cfg.near - 0.1, cfg.near, cfg.far, int(want_color),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raymarch_fwd launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


class _RenderImage(torch.autograd.Function):
    """The kernel as an autograd node whose backward is still to port."""

    @staticmethod
    def forward(ctx, params, v19, lib, cfg, want_color):
        out = launch(lib, params.detach(), v19.detach(), cfg, want_color)
        shape = (cfg.height, cfg.width, 3) if want_color else (cfg.height, cfg.width)
        return out.view(shape)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the backward of the CUDA render kernel (the port of "
            "raymarch_kernel._pallas_render_image_bwd) does not exist yet; "
            "render with backend='torch' to differentiate"
        )


def _render(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig, want_color: bool):
    _check("view", view, (4, 4))
    program = compile_scene(expr)
    params = flat_params(expr)
    if params.numel() != program.n_params:
        raise ValueError(f"{params.numel()} parameters for a program of {program.n_params} slots")
    lib = build.load(program)
    return _RenderImage.apply(params, view19(view, cfg), lib, cfg, want_color)


def render_image_kernel(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W, 3) RGB through the CUDA kernel."""
    return _render(expr, view, cfg, True)


def render_depth_image_kernel(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W) depth through the CUDA kernel."""
    return _render(expr, view, cfg, False)
