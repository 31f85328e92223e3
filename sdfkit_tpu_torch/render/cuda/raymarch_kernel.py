"""The sphere-trace CUDA kernels, forward and backward, and their PyTorch wrapper.

The forward replaces ``sdfkit_tpu/render/pallas/raymarch_kernel.py``
``_pallas_render_image_flat`` (reached through ``render_image_fused`` and
``render_depth_image_fused``), and the backward replaces
``_pallas_render_image_bwd`` (``store=None``), the pullback that
``_image_fused_bwd`` calls. The plain version of both is
``render/raymarch.py``'s ``render_image_torch`` / ``render_depth_image_torch``
and autograd through them.

What bounds them on an H100: arithmetic. The forward runs about 46 scene
evaluations per pixel and writes 12 bytes (RGB); the backward runs those
again (it replays the march) plus about 46 forward-and-reverse evaluations,
reads the 12 bytes of cotangent and writes ``n_params + 19`` floats per
block. Both designs keep a pixel's whole march in registers and thread-local
memory: one thread makes its ray from the pixel index and 19 view scalars,
and reads nothing else from device memory but the flat parameter buffer. The
backward sums over pixels without atomics (per-block partial rows, then a
second kernel in a fixed order), so its gradients are bit-reproducible. The
sources are ``csrc/raymarch_fwd.cu(h)`` and ``csrc/raymarch_bwd.cu(h)``; the
scene body and its adjoint come from the scene compiler and the builds from
``build.py``.

``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches, so a run can show
that its frames and gradients went through the kernels. The wrappers take
CUDA float32 tensors only and raise on anything else; the CPU is served by
``RayMarcher(backend="auto")`` choosing the plain path. Nothing here falls
back to the plain path when a build or a launch fails.
"""

from __future__ import annotations

import torch

from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params
from sdfkit_tpu_torch.sdf.expr import SdfExpr
from sdfkit_tpu_torch.utils.camera import inv_view_proj

LAUNCHES = 0  # forward kernel launches
BWD_LAUNCHES = 0  # backward launches (the pullback kernel and its reduction)


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


def _pixel_count(cfg: RenderConfig, pix0: int, local_npix: int | None) -> int:
    """The pixels a launch covers, checked against the image."""
    npix = cfg.width * cfg.height
    if local_npix is None:
        local_npix = npix
    if npix >= 2**31 or not 0 <= pix0 <= pix0 + local_npix <= npix:
        raise ValueError(f"pixel range [{pix0}, {pix0 + local_npix}) of a {npix}-pixel image")
    return local_npix


def launch(lib: build.KernelLib, params: torch.Tensor, v19: torch.Tensor, cfg: RenderConfig,
           want_color: bool, pix0: int = 0, local_npix: int | None = None) -> torch.Tensor:
    """Run the kernel over ``local_npix`` pixels from flat pixel ``pix0``:
    (local_npix, 3) RGB or (local_npix,) depth, on the current stream."""
    global LAUNCHES
    local_npix = _pixel_count(cfg, pix0, local_npix)
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


def launch_bwd(lib: build.KernelLib, params: torch.Tensor, v19: torch.Tensor,
               cfg: RenderConfig, want_color: bool, grad: torch.Tensor, pix0: int = 0,
               local_npix: int | None = None) -> torch.Tensor:
    """Run the pullback over ``local_npix`` pixels from flat pixel ``pix0``
    and sum it over them, on the current stream. ``grad`` is the cotangent of
    those pixels, (local_npix, 3) RGB or (local_npix,) depth. Returns
    ``n_params + 19`` floats: the cotangents of the flat parameter buffer,
    then of ``view19``."""
    global BWD_LAUNCHES
    local_npix = _pixel_count(cfg, pix0, local_npix)
    if not 1 <= cfg.depth_iterations <= build.MAX_BWD_ITERS:
        raise ValueError(
            f"the backward kernel keeps a depth history of at most {build.MAX_BWD_ITERS} "
            f"march iterations, got {cfg.depth_iterations}; differentiate with backend='torch'"
        )
    _check("params", params)
    _check("view19", v19, (19,))
    _check("grad", grad, (local_npix, 3) if want_color else (local_npix,))
    if not v19.device == grad.device == params.device:
        raise ValueError(
            f"the scene is on {params.device}, the view on {v19.device} and the "
            f"cotangent on {grad.device}"
        )
    n_out = params.numel() + 19
    out = torch.empty(n_out, dtype=torch.float32, device=params.device)
    if local_npix == 0:
        return out.zero_()
    with torch.cuda.device(params.device):
        rows = lib.rows(local_npix)
        if rows <= 0:
            raise RuntimeError(f"raymarch_bwd could not size its grid (CUDA error {-rows})")
        partials = torch.empty((rows, n_out), dtype=torch.float32, device=params.device)
        rc = lib.launch(
            params.data_ptr(), v19.data_ptr(), cfg.width, cfg.height, pix0, local_npix,
            cfg.depth_iterations, cfg.near - 0.1, cfg.near, cfg.far, int(want_color),
            grad.data_ptr(), partials.data_ptr(), rows, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raymarch_bwd launch failed with CUDA error {rc}")
    BWD_LAUNCHES += 1
    return out


def _check_cotangent(grad: torch.Tensor) -> None:
    if grad.device.type != "cuda" or grad.dtype != torch.float32:
        raise ValueError(
            f"the cotangent of a kernel render must be a CUDA float32 tensor, "
            f"got {grad.device} {grad.dtype}"
        )


class _RenderImage(torch.autograd.Function):
    """Both kernels as one autograd node: ``params`` is the flat parameter
    buffer and ``v19`` the view scalars, so the leaves' gradients flow on
    through ``flat_params`` and the view's through ``view19``."""

    @staticmethod
    def forward(ctx, params, v19, program, cfg, want_color):
        params, v19 = params.detach().contiguous(), v19.detach().contiguous()
        out = launch(build.load(program), params, v19, cfg, want_color)
        ctx.save_for_backward(params, v19)
        ctx.program, ctx.cfg, ctx.want_color = program, cfg, want_color
        shape = (cfg.height, cfg.width, 3) if want_color else (cfg.height, cfg.width)
        return out.view(shape)

    @staticmethod
    def backward(ctx, grad):
        params, v19 = ctx.saved_tensors
        _check_cotangent(grad)
        npix = ctx.cfg.width * ctx.cfg.height
        grad = grad.contiguous().view((npix, 3) if ctx.want_color else (npix,))
        out = launch_bwd(build.load_bwd(ctx.program), params, v19, ctx.cfg, ctx.want_color, grad)
        n = params.numel()
        return out[:n], out[n:], None, None, None


def _render(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig, want_color: bool):
    _check("view", view, (4, 4))
    program = compile_scene(expr)
    params = flat_params(expr)
    if params.numel() != program.n_params:
        raise ValueError(f"{params.numel()} parameters for a program of {program.n_params} slots")
    return _RenderImage.apply(params, view19(view, cfg), program, cfg, want_color)


def render_image_kernel(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W, 3) RGB through the CUDA kernel, differentiable in the scene's
    parameters and the view."""
    return _render(expr, view, cfg, True)


def render_depth_image_kernel(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W) depth through the CUDA kernel."""
    return _render(expr, view, cfg, False)
