"""The sphere-trace CUDA kernels and their PyTorch wrappers.

Every function of ``sdfkit_tpu/render/pallas/raymarch_kernel.py`` that reaches
``pl.pallas_call`` has its counterpart here:

* ``launch`` / ``render_image_kernel`` / ``render_rows_kernel`` (and the depth
  forms) replace ``_pallas_render_image_flat`` behind ``render_image_fused``
  and ``render_rows_fused``: rays from the flat pixel index, for a whole frame
  or a band of rows (``pix0``).
* ``launch_bwd`` replaces ``_pallas_render_image_bwd``, the pullback that
  ``_image_fused_bwd`` and ``_rows_fused_bwd`` call.
* ``launch(..., want_store=True)`` and ``launch_bwd(..., store=...)`` replace
  the depth-history handoff between those two (``want_store`` / ``store``):
  the forward also writes every step's depth, and the backward reads them in
  place of its replay of the march. As in the JAX package, the autograd node
  itself replays (``PERF.md`` has both sides' times on the card).
* ``launch_rays`` / ``render_rays_kernel`` / ``render_depth_rays_kernel``
  replace ``_pallas_render_flat`` behind ``render_rays_fused``: rays given as
  arrays. ``launch_rays_bwd`` is its pullback (the JAX package differentiates
  this path through its plain version; on the card that is a kernel too): a
  tangent march, which carries the derivatives of the depth along the march
  and needs no replay. A colour render that autograd records also keeps one
  byte per ray, whether it hit (``launch_rays(..., want_hit=True)``), and the
  pullback skips the rays that did not.

The plain version of all of them is ``render/raymarch.py``: ``render_rays`` /
``render_depth_rays`` (on ``camera_rays`` for the image forms), autograd
through them, and ``march_history`` for the depth history.

What bounds them on an H100 (``PERF.md`` has the measurements): the forwards
start an instruction nearly every cycle (about 46 scene evaluations per ray,
12 bytes written), so only a shorter instruction stream makes them faster:
the scene compiler writes a division by a uniform as a reciprocal taken
once and two multiply-adds, and the parameters and the view come through
constant memory (``csrc/raymarch_uniforms.cuh``; device memory for a scene too
large for the 64 KB bank; one buffer per library and card, so a launch on
another stream than the library's last on its card waits for that one). The
image backward runs those evaluations again (it replays the march) plus
about 46 gradients of the scene; it is written so that many warps are in
flight (uniforms in constant memory, a register budget set for five blocks an
SM, one full wave of blocks) and so that the chain is short (the sweep takes
each step's gradient for a cotangent of one, independent of the steps around
it, and scales it after). Fed the forward's depth history it replays
nothing, and stages each hit pixel's depths in shared memory ahead of its
sweep. The ray-batch backward takes one gradient of the scene per march step
and nothing else (the tangent march). All designs keep a ray's whole march
in registers and thread-local memory; the image kernels make the ray from
the pixel index and 19 view scalars. The backwards take any number of march
iterations: the image backward keeps 64 depths at a time and replays the
march once more for every further 64, the others need no kept depths. They
sum over pixels without atomics (per-block partial rows, then a second kernel
in a fixed order), so their gradients are bit-reproducible. The sources are
under ``csrc/``; the scene body and its adjoint come from the scene compiler
and the builds from ``build.py``.

The ``*LAUNCHES`` counters count kernel launches, one counter per kernel, so
a run can show that its frames and gradients went through the kernels. The
wrappers take CUDA float32 tensors only and raise on anything else; the CPU
is served by ``resolve_backend`` choosing the plain path. Nothing here falls
back to the plain path when a build or a launch fails.
"""

from __future__ import annotations

import torch

from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params
from sdfkit_tpu_torch.sdf.expr import SdfExpr
from sdfkit_tpu_torch.utils.camera import inv_view_proj
from sdfkit_tpu_torch.utils.spans import span
from sdfkit_tpu_torch.utils.v3 import V3

LAUNCHES = 0  # image forward launches
BWD_LAUNCHES = 0  # image backward launches (the pullback kernel and its reduction)
STORE_LAUNCHES = 0  # image forward launches that also wrote the depth history
STORE_BWD_LAUNCHES = 0  # image backward launches that read the depth history
RAYS_LAUNCHES = 0  # ray-batch forward launches
RAYS_BWD_LAUNCHES = 0  # ray-batch backward launches (pullback kernel and reduction)


def view19(view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """inverse(view @ proj) row-major (16) then the camera position (3), in
    float32 on the view's device -- the host-side prep of the TPU kernel
    (``_view_to_ivp_cam``)."""
    ivp, cam = inv_view_proj(view, cfg.width, cfg.height, cfg.vfov_degrees, cfg.near, cfg.far)
    return torch.cat([ivp.reshape(16), cam.reshape(3)]).contiguous()


def _check_cuda_float32(name: str, t) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name} must be a CUDA float32 tensor, got {t.device} {t.dtype}")


def _check(name: str, t: torch.Tensor, shape=None) -> None:
    """What a launch hands to a kernel as a pointer."""
    _check_cuda_float32(name, t)
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


def _scalars(cfg: RenderConfig, want_color: bool) -> tuple:
    """iters, depth0, near, far, want_color, as every launcher takes them."""
    return (cfg.depth_iterations, cfg.near - 0.1, cfg.near, cfg.far, int(want_color))


def _check_store_build(lib: build.KernelLib, store: bool) -> None:
    if lib.store != store:
        raise ValueError(
            f"the depth history needs the library built for it (build.load(program, store=True)): "
            f"store={store} with a library built with store={lib.store}"
        )


def _run(lib: build.KernelLib, what: str, *args) -> None:
    """``lib.launch(*args, stream)`` on the current stream of the current
    device, after the library's last launch where that was on another stream
    (a library's uniforms are one buffer). Raises on a CUDA error."""
    stream = torch.cuda.current_stream()
    with lib.lock:
        lib.order_uniforms(stream)
        rc = lib.launch(*args, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {rc}")


def launch(lib: build.KernelLib, params: torch.Tensor, v19: torch.Tensor, cfg: RenderConfig,
           want_color: bool, pix0: int = 0, local_npix: int | None = None,
           want_store: bool = False):
    """Run the kernel over ``local_npix`` pixels from flat pixel ``pix0``:
    (local_npix, 3) RGB or (local_npix,) depth, on the current stream.

    ``want_store`` (with ``lib = build.load(program, store=True)``) returns
    ``(out, store)``: ``store`` is the (depth_iterations, local_npix) depth
    history, row ``i`` the depth before march step ``i`` and the last row the
    depth before the final step, for ``launch_bwd(..., store=store)``."""
    global LAUNCHES, STORE_LAUNCHES
    local_npix = _pixel_count(cfg, pix0, local_npix)
    _check("params", params)
    _check("view19", v19, (19,))
    if v19.device != params.device:
        raise ValueError(f"the view is on {v19.device} but the scene is on {params.device}")
    _check_store_build(lib, want_store)
    out = torch.empty(
        (local_npix, 3) if want_color else (local_npix,), dtype=torch.float32,
        device=params.device,
    )
    store = None
    if want_store:
        store = torch.empty((cfg.depth_iterations, local_npix), dtype=torch.float32,
                            device=params.device)
    if local_npix == 0:
        return (out, store) if want_store else out
    with torch.cuda.device(params.device):
        _run(lib, "raymarch_fwd", params.data_ptr(), v19.data_ptr(), cfg.width, cfg.height, pix0,
             local_npix, *_scalars(cfg, want_color), out.data_ptr(),
             store.data_ptr() if want_store else None)
    if want_store:
        STORE_LAUNCHES += 1
        return out, store
    LAUNCHES += 1
    return out


def _partials(lib: build.KernelLib, count: int, n_out: int, want_color: bool,
              device) -> torch.Tensor:
    """The (rows, n_out) scratch of a backward launch over ``count`` pixels
    or rays; call it with ``device`` current."""
    rows = lib.rows(count, int(want_color))
    if rows <= 0:
        raise RuntimeError(f"the backward could not size its grid (CUDA error {-rows})")
    return torch.empty((rows, n_out), dtype=torch.float32, device=device)


def launch_bwd(lib: build.KernelLib, params: torch.Tensor, v19: torch.Tensor,
               cfg: RenderConfig, want_color: bool, grad: torch.Tensor, pix0: int = 0,
               local_npix: int | None = None, store: torch.Tensor | None = None) -> torch.Tensor:
    """Run the pullback over ``local_npix`` pixels from flat pixel ``pix0``
    and sum it over them, on the current stream. ``grad`` is the cotangent of
    those pixels, (local_npix, 3) RGB or (local_npix,) depth. Returns
    ``n_params + 19`` floats: the cotangents of the flat parameter buffer,
    then of ``view19``.

    ``store`` (with ``lib = build.load_bwd(program, store=True)``) is the
    depth history a ``launch(..., want_store=True)`` over the same pixels
    returned; the kernel then reads it instead of replaying the march."""
    global BWD_LAUNCHES, STORE_BWD_LAUNCHES
    local_npix = _pixel_count(cfg, pix0, local_npix)
    _check("params", params)
    _check("view19", v19, (19,))
    _check("grad", grad, (local_npix, 3) if want_color else (local_npix,))
    if not v19.device == grad.device == params.device:
        raise ValueError(
            f"the scene is on {params.device}, the view on {v19.device} and the "
            f"cotangent on {grad.device}"
        )
    _check_store_build(lib, store is not None)
    if store is not None:
        _check("store", store, (cfg.depth_iterations, local_npix))
        if store.device != params.device:
            raise ValueError(f"the depth history is on {store.device}, the scene on {params.device}")
    n_out = params.numel() + 19
    out = torch.empty(n_out, dtype=torch.float32, device=params.device)
    if local_npix == 0:
        return out.zero_()
    with torch.cuda.device(params.device):
        partials = _partials(lib, local_npix, n_out, want_color, params.device)
        _run(lib, "raymarch_bwd", params.data_ptr(), v19.data_ptr(), cfg.width, cfg.height, pix0,
             local_npix, *_scalars(cfg, want_color), grad.data_ptr(),
             None if store is None else store.data_ptr(), partials.data_ptr(),
             partials.shape[0], out.data_ptr())
    if store is None:
        BWD_LAUNCHES += 1
    else:
        STORE_BWD_LAUNCHES += 1
    return out


def _check_rays(params: torch.Tensor, rays) -> int:
    """``rays``: the six components ox, oy, oz, dx, dy, dz, each a contiguous
    (n,) float32 tensor on the scene's device. Returns n."""
    _check("params", params)
    if len(rays) != 6:
        raise ValueError(f"rays are six components (ox, oy, oz, dx, dy, dz), got {len(rays)}")
    for name, c in zip(("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z"), rays):
        _check(name, c, tuple(rays[0].shape))
        if c.ndim != 1:
            raise ValueError(f"{name} must be flat, got shape {tuple(c.shape)}")
        if c.device != params.device:
            raise ValueError(f"{name} is on {c.device} but the scene is on {params.device}")
    n = rays[0].numel()
    if n >= 2**31:
        raise ValueError(f"{n} rays in one launch; the kernel indexes them with 32 bits")
    return n


def launch_rays(lib: build.KernelLib, params: torch.Tensor, rays, cfg: RenderConfig,
                want_color: bool, want_hit: bool = False):
    """Run the ray-batch kernel over n rays given as six (n,) component
    tensors: (n, 3) RGB or (n,) depth, on the current stream. Only the march
    settings of ``cfg`` are read.

    ``want_hit`` (RGB only) returns ``(out, hit)``: ``hit`` is the (n,) bool
    flag of the rays that hit, for ``launch_rays_bwd(..., hit=hit)``."""
    global RAYS_LAUNCHES
    if want_hit and not want_color:
        raise ValueError("the hit flag is a colour render's: a depth has a gradient on every ray")
    n = _check_rays(params, rays)
    out = torch.empty((n, 3) if want_color else (n,), dtype=torch.float32, device=params.device)
    hit = torch.empty(n, dtype=torch.bool, device=params.device) if want_hit else None
    if n > 0:
        with torch.cuda.device(params.device):
            _run(lib, "raymarch_rays_fwd", params.data_ptr(), *(c.data_ptr() for c in rays), n,
                 *_scalars(cfg, want_color), out.data_ptr(), hit.data_ptr() if want_hit else None)
        RAYS_LAUNCHES += 1
    return (out, hit) if want_hit else out


def launch_rays_bwd(lib: build.KernelLib, params: torch.Tensor, rays, cfg: RenderConfig,
                    want_color: bool, grad: torch.Tensor, hit: torch.Tensor | None = None,
                    want_depths: bool = False):
    """Run the ray-batch pullback on the current stream. ``grad`` is the
    cotangent of ``launch_rays``'s output. Returns ``(g_params, g_rays)``:
    the (n_params,) cotangent of the flat parameter buffer, summed over the
    rays, and the (6, n) cotangents of the six ray components.

    ``hit`` is the forward's hit flag of the same rays (``launch_rays(...,
    want_hit=True)``, RGB only): a ray that missed has the sky's constant
    colour, gets a zero cotangent and costs no march. Without it every ray
    is marched, and one that misses still adds exactly nothing.
    ``want_depths`` also returns the (n,) depth each ray's march reached
    (before the final step in RGB; NaN where ``hit`` skipped the ray)."""
    global RAYS_BWD_LAUNCHES
    n = _check_rays(params, rays)
    _check("grad", grad, (n, 3) if want_color else (n,))
    if grad.device != params.device:
        raise ValueError(f"the cotangent is on {grad.device} but the scene is on {params.device}")
    if hit is not None:
        if not want_color:
            raise ValueError("the hit flag is a colour render's: a depth has a gradient on "
                             "every ray")
        if not isinstance(hit, torch.Tensor) or hit.dtype != torch.bool or hit.shape != (n,):
            raise ValueError(f"hit must be an ({n},) bool tensor")
        if hit.device != params.device or not hit.is_contiguous():
            raise ValueError(f"hit must be contiguous on {params.device}")
    n_out = params.numel()
    g_params = torch.empty(n_out, dtype=torch.float32, device=params.device)
    g_rays = torch.empty((6, n), dtype=torch.float32, device=params.device)
    depths = torch.empty(n, dtype=torch.float32, device=params.device) if want_depths else None
    if n == 0:
        g_params.zero_()
    else:
        with torch.cuda.device(params.device):
            partials = _partials(lib, n, n_out, want_color, params.device)
            _run(lib, "raymarch_rays_bwd", params.data_ptr(), *(c.data_ptr() for c in rays), n,
                 *_scalars(cfg, want_color), grad.data_ptr(),
                 None if hit is None else hit.data_ptr(), g_rays.data_ptr(),
                 depths.data_ptr() if want_depths else None, partials.data_ptr(),
                 partials.shape[0], g_params.data_ptr())
        RAYS_BWD_LAUNCHES += 1
    return (g_params, g_rays, depths) if want_depths else (g_params, g_rays)


class _RenderImage(torch.autograd.Function):
    """The image kernels as one autograd node, for a whole frame or a band of
    ``n_rows`` rows from flat pixel ``pix0``: ``params`` is the flat parameter
    buffer and ``v19`` the view scalars, so the leaves' gradients flow on
    through ``flat_params`` and the view's through whatever made ``v19``. The
    backward replays the march (see the module docstring)."""

    @staticmethod
    def forward(ctx, params, v19, program, cfg, want_color, pix0=0, n_rows=None):
        with span("sdf.render.launch"):
            params, v19 = params.detach().contiguous(), v19.detach().contiguous()
            n_rows = cfg.height if n_rows is None else n_rows
            out = launch(build.load(program), params, v19, cfg, want_color, pix0,
                         n_rows * cfg.width)
            ctx.save_for_backward(params, v19)
            ctx.program, ctx.cfg, ctx.want_color = program, cfg, want_color
            ctx.pix0, ctx.n_rows = pix0, n_rows
            return out.view((n_rows, cfg.width, 3) if want_color else (n_rows, cfg.width))

    @staticmethod
    def backward(ctx, grad):
        with span("sdf.render.backward"):
            params, v19 = ctx.saved_tensors
            _check_cuda_float32("the cotangent of a kernel render", grad)
            npix = ctx.n_rows * ctx.cfg.width
            grad = grad.contiguous().view((npix, 3) if ctx.want_color else (npix,))
            out = launch_bwd(build.load_bwd(ctx.program), params, v19, ctx.cfg, ctx.want_color,
                             grad, ctx.pix0, npix)
            n = params.numel()
            return out[:n], out[n:], None, None, None, None, None


class _RenderRays(torch.autograd.Function):
    """The ray-batch kernels as one autograd node: ``params`` is the flat
    parameter buffer and the six ray components tensors of one shape. A
    component that is not contiguous (``camera_rays`` hands out stride-0
    origins) is copied; autograd sums a broadcast component's cotangent.
    ``want_hit``: the forward also keeps the rays' hit flags (one byte a ray)
    for the backward, which then skips the rays that missed."""

    @staticmethod
    def forward(ctx, params, ox, oy, oz, dx, dy, dz, program, cfg, want_color, want_hit):
        with span("sdf.render.launch"):
            shape = ox.shape
            params = params.detach().contiguous()
            rays = tuple(c.detach().contiguous().view(-1) for c in (ox, oy, oz, dx, dy, dz))
            out = launch_rays(build.load_rays(program), params, rays, cfg, want_color, want_hit)
            ctx.hit = None
            if want_hit:
                out, ctx.hit = out
            ctx.save_for_backward(params, *rays)
            ctx.program, ctx.cfg, ctx.want_color, ctx.shape = program, cfg, want_color, shape
            return out.view((*shape, 3) if want_color else shape)

    @staticmethod
    def backward(ctx, grad):
        with span("sdf.render.backward"):
            params, *rays = ctx.saved_tensors
            _check_cuda_float32("the cotangent of a kernel render", grad)
            n = rays[0].numel()
            grad = grad.contiguous().view((n, 3) if ctx.want_color else (n,))
            g_params, g_rays = launch_rays_bwd(build.load_rays_bwd(ctx.program), params, rays,
                                               ctx.cfg, ctx.want_color, grad, ctx.hit)
            return (g_params, *(g.view(ctx.shape) for g in g_rays), None, None, None, None)


def _program_and_params(expr: SdfExpr):
    with span("sdf.render.params"):
        program = compile_scene(expr)
        params = flat_params(expr)
    if params.numel() != program.n_params:
        raise ValueError(f"{params.numel()} parameters for a program of {program.n_params} slots")
    return program, params


def _render(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig, want_color: bool):
    _check("view", view, (4, 4))
    program, params = _program_and_params(expr)
    with span("sdf.render.view"):
        v19 = view19(view, cfg)
    return _RenderImage.apply(params, v19, program, cfg, want_color)


def render_image_kernel(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W, 3) RGB through the CUDA kernel, differentiable in the scene's
    parameters and the view."""
    return _render(expr, view, cfg, True)


def render_depth_image_kernel(expr: SdfExpr, view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(H, W) depth through the CUDA kernel."""
    return _render(expr, view, cfg, False)


def _render_rows(expr, ivp, cam, pix0, cfg, n_rows, want_color):
    for name, t, count in (("ivp", ivp, 16), ("cam", cam, 3)):
        _check_cuda_float32(name, t)  # any strides: torch.cat below packs them
        if t.numel() != count:
            raise ValueError(f"{name} must hold {count} values, got shape {tuple(t.shape)}")
    pix0, n_rows = int(pix0), int(n_rows)
    _pixel_count(cfg, pix0, n_rows * cfg.width)
    program, params = _program_and_params(expr)
    with span("sdf.render.view"):
        v19 = torch.cat([ivp.reshape(16), cam.reshape(3)])
    return _RenderImage.apply(params, v19, program, cfg, want_color, pix0, n_rows)


def render_rows_kernel(expr: SdfExpr, ivp: torch.Tensor, cam: torch.Tensor, pix0,
                       cfg: RenderConfig, n_rows: int) -> torch.Tensor:
    """(n_rows, W, 3) RGB of the rows that start at flat pixel ``pix0`` of the
    ``cfg.width`` x ``cfg.height`` image, through the CUDA kernels (the JAX
    package's ``render_rows_fused``). ``ivp`` (16 values, inverse(view @ proj)
    row-major) and ``cam`` (3) come from ``inv_view_proj``. Differentiable in
    the scene, ``ivp`` and ``cam``; ``pix0``, a Python int or a 0-d integer
    tensor, gets no gradient."""
    return _render_rows(expr, ivp, cam, pix0, cfg, n_rows, True)


def render_depth_rows_kernel(expr: SdfExpr, ivp: torch.Tensor, cam: torch.Tensor, pix0,
                             cfg: RenderConfig, n_rows: int) -> torch.Tensor:
    """Depth form of ``render_rows_kernel``: (n_rows, W)."""
    return _render_rows(expr, ivp, cam, pix0, cfg, n_rows, False)


def _render_rays(expr: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig, want_color: bool):
    comps = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)
    for name, c in zip(("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z"), comps):
        _check_cuda_float32(name, c)
        if c.shape != comps[0].shape:
            raise ValueError(
                f"{name} has shape {tuple(c.shape)} but ro.x has {tuple(comps[0].shape)}"
            )
    program, params = _program_and_params(expr)
    # The hit flags are kept only where autograd records the render.
    want_hit = want_color and torch.is_grad_enabled() and any(
        t.requires_grad for t in (params, *comps))
    return _RenderRays.apply(params, *comps, program, cfg, want_color, want_hit)


def render_rays_kernel(expr: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> torch.Tensor:
    """(..., 3) RGB for rays given as arrays, through the CUDA kernels (the JAX
    package's ``render_rays_fused``). The six components of ``ro`` and ``rd``
    share one shape; only the march settings of ``cfg`` are read.
    Differentiable in the scene, ``ro`` and ``rd``."""
    return _render_rays(expr, ro, rd, cfg, True)


def render_depth_rays_kernel(expr: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> torch.Tensor:
    """Depth form of ``render_rays_kernel``: (...) in the rays' shape."""
    return _render_rays(expr, ro, rd, cfg, False)
