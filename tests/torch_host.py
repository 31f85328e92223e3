"""The kernels' per-ray code built for the host, standing in for the launches.

``csrc/raymarch_fwd.cuh`` and ``csrc/raymarch_bwd.cuh`` hold host-and-device
code with no CUDA header. ``host_library`` compiles them with g++ together
with a scene's emitted functions, the shim that defines the CUDA qualifiers
away, and host loops over the pixels or rays: one loop per kernel family of
``render/cuda/build.py`` (image forward and backward, their depth-history
variants, ray-batch forward and backward). The backward loops sum in float64
(the kernels sum in float32, block by block).

``patch_kernels`` puts those loops in place of the launch functions of
``render/cuda/raymarch_kernel.py``, so that the wrappers' own plumbing
(layouts, autograd nodes, the split into leaf, view and ray cotangents) runs
on CPU tensors in the tests. The ray-batch loops are the kernel's: the forward
writes the hit flags it is asked for, and the pullback is the tangent march
(``tangent_pullback_ray``) that skips a ray flagged as a miss. The library
also holds the image pullback's replay and sweep (``pullback_ray``) run on
given rays, which the tangent march is held against.
"""

import ctypes

import numpy as np
import torch

from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from test_torch_kernel_host import LOOP, SHIM, _gxx

LOOP_BWD = """
#include "raymarch_bwd.cuh"

// A pixel's or a ray's pullback in the scene's tier: the large tier adds to
// the thread's sums as the small tier's arrays do (raymarch_sums.cuh).
#if SDF_LARGE
#define PULL_PIXEL(C, ...) pullback_pixel_large<C>(__VA_ARGS__)
#define PULL_RAY(C, ...) pullback_ray_large<C>(__VA_ARGS__)
#define ACTIVE true,
#else
#define PULL_PIXEL(C, ...) pullback_pixel<C>(__VA_ARGS__)
#define PULL_RAY(C, ...) pullback_ray<C>(__VA_ARGS__)
#define ACTIVE
#endif

extern "C" void raymarch_bwd_host(const float* P, const float* view19, int width,
                                  int height, int pix0, int local_npix, int iters,
                                  float depth0, float near_, float far_, int want_color,
                                  const float* grad, double* out) {
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  const int n_out = SDF_N_PARAMS + 19;
  for (int j = 0; j < n_out; ++j) out[j] = 0.0;
  for (int i = 0; i < local_npix; ++i) {
    float acc[SDF_N_PARAMS + 19] = {0.0f};
    if (want_color) PULL_PIXEL(true, pix0 + i, ACTIVE P, view19, a, grad + 3 * i, acc, acc + SDF_N_PARAMS);
    else PULL_PIXEL(false, pix0 + i, ACTIVE P, view19, a, grad + i, acc, acc + SDF_N_PARAMS);
    for (int j = 0; j < n_out; ++j) out[j] += (double)acc[j];
  }
}
"""

LOOP_STORE = """
extern "C" void raymarch_fwd_store_host(const float* P, const float* view19, int width,
                                        int height, int pix0, int local_npix, int iters,
                                        float depth0, float near_, float far_, int want_color,
                                        float* out, float* store) {
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  for (int i = 0; i < local_npix; ++i) {
    if (want_color) shade_pixel<true, true>(pix0 + i, P, view19, a, out, store);
    else shade_pixel<false, true>(pix0 + i, P, view19, a, out, store);
  }
}

extern "C" void raymarch_bwd_store_host(const float* P, const float* view19, int width,
                                        int height, int pix0, int local_npix, int iters,
                                        float depth0, float near_, float far_, int want_color,
                                        const float* grad, const float* store, double* out) {
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  const int n_out = SDF_N_PARAMS + 19;
  for (int j = 0; j < n_out; ++j) out[j] = 0.0;
  for (int i = 0; i < local_npix; ++i) {
    float acc[SDF_N_PARAMS + 19] = {0.0f};
    const StoreRows rows{store + i, local_npix};
    float* gV = acc + SDF_N_PARAMS;
    if (want_color) PULL_PIXEL(true, pix0 + i, ACTIVE P, view19, a, grad + 3 * i, acc, gV, rows);
    else PULL_PIXEL(false, pix0 + i, ACTIVE P, view19, a, grad + i, acc, gV, rows);
    for (int j = 0; j < n_out; ++j) out[j] += (double)acc[j];
  }
}
"""

LOOP_RAYS = """
extern "C" void raymarch_rays_fwd_host(const float* P, const float* ox, const float* oy,
                                       const float* oz, const float* dx, const float* dy,
                                       const float* dz, int n, int iters, float depth0,
                                       float near_, float far_, int want_color, float* out,
                                       unsigned char* hit) {
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  for (int i = 0; i < n; ++i) {
    const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
    if (hit != nullptr) shade_ray<true, false, true>(r, P, a, out + 3 * i, nullptr, 0, hit + i);
    else if (want_color) shade_ray<true>(r, P, a, out + 3 * i);
    else shade_ray<false>(r, P, a, out + i);
  }
}

// The ray-batch kernel's loop: the tangent march (in the large tier the
// replay and the sweep), a ray flagged as a miss skipped; depths (NaN for a
// skipped ray) where asked for.
extern "C" void raymarch_rays_bwd_host(const float* P, const float* ox, const float* oy,
                                       const float* oz, const float* dx, const float* dy,
                                       const float* dz, int n, int iters, float depth0,
                                       float near_, float far_, int want_color,
                                       const float* grad, const unsigned char* hit,
                                       float* g_rays, float* depths, double* out) {
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  for (int j = 0; j < SDF_N_PARAMS; ++j) out[j] = 0.0;
  for (int i = 0; i < n; ++i) {
    const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
    float acc[SDF_N_PARAMS + 1] = {0.0f};
    RayGrad gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float depth = NAN;
    if (hit == nullptr || hit[i]) {
#if SDF_LARGE
      const float* g = grad + (want_color ? 3 : 1) * i;
      if (want_color) pullback_ray_large<true>(r, true, P, a, g, acc, gr, ReplayRows(), &depth);
      else pullback_ray_large<false>(r, true, P, a, g, acc, gr, ReplayRows(), &depth);
#else
      if (want_color) tangent_pullback_ray<true>(r, P, a, grad + 3 * i, acc, gr, depth);
      else tangent_pullback_ray<false>(r, P, a, grad + i, acc, gr, depth);
#endif
    }
    const float g6[6] = {gr.ox, gr.oy, gr.oz, gr.dx, gr.dy, gr.dz};
    for (int k = 0; k < 6; ++k) g_rays[(long long)k * n + i] = g6[k];
    if (depths != nullptr) depths[i] = depth;
    for (int j = 0; j < SDF_N_PARAMS; ++j) out[j] += (double)acc[j];
  }
}

// The image pullback's replay and sweep (pullback_ray) on given rays, as the
// ray-batch kernel ran them before the tangent march.
extern "C" void raymarch_rays_bwd_replay_host(const float* P, const float* ox, const float* oy,
                                              const float* oz, const float* dx, const float* dy,
                                              const float* dz, int n, int iters, float depth0,
                                              float near_, float far_, int want_color,
                                              const float* grad, float* g_rays, double* out) {
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  for (int j = 0; j < SDF_N_PARAMS; ++j) out[j] = 0.0;
  for (int i = 0; i < n; ++i) {
    const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
    float acc[SDF_N_PARAMS + 1] = {0.0f};
    RayGrad gr;
    if (want_color) PULL_RAY(true, r, ACTIVE P, a, grad + 3 * i, acc, gr);
    else PULL_RAY(false, r, ACTIVE P, a, grad + i, acc, gr);
    const float g6[6] = {gr.ox, gr.oy, gr.oz, gr.dx, gr.dy, gr.dz};
    for (int k = 0; k < 6; ++k) g_rays[(long long)k * n + i] = g6[k];
    for (int j = 0; j < SDF_N_PARAMS; ++j) out[j] += (double)acc[j];
  }
}
"""

_P = ctypes.c_void_p
_IMAGE = [_P] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3 + [ctypes.c_int]
_RAYS = [_P] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_int]
_SIGNATURES = {
    "raymarch_fwd_host": _IMAGE + [_P],
    "raymarch_bwd_host": _IMAGE + [_P, _P],
    "raymarch_fwd_store_host": _IMAGE + [_P, _P],
    "raymarch_bwd_store_host": _IMAGE + [_P, _P, _P],
    "raymarch_rays_fwd_host": _RAYS + [_P, _P],
    "raymarch_rays_bwd_host": _RAYS + [_P] * 5,
    "raymarch_rays_bwd_replay_host": _RAYS + [_P, _P, _P],
}


def host_library(build_dir, program, extra=""):
    """The g++ build of every kernel family's per-ray code for ``program``,
    with ``extra`` (a test's own host code) appended to the unit. A library
    that an earlier call built in ``build_dir`` from the same unit is loaded
    as it is (the ranks of ``tools/torch_distributed_demo.py`` load what the
    test built)."""
    src = build_dir / f"scene_{program.adjoint_hash}.cc"
    unit = (SHIM + program.source + program.adjoint_source + LOOP + LOOP_BWD + LOOP_STORE
            + LOOP_RAYS + extra)
    so = src.with_suffix(".so")
    if so.exists() and src.exists() and src.read_text() == unit:
        lib = ctypes.CDLL(str(so))
    else:
        src.write_text(unit)
        # A scene of the large tier compiles unoptimised: g++ -O2 is slow on
        # an adjoint of that size, and x86-64's SSE arithmetic (no FMA in its
        # base set) gives the same floats either way.
        lib = _gxx(src, so, "-O0" if program.large else "-O2")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    return lib


def host_libraries(build_dir):
    """program -> its host library, built once."""
    libs = {}

    def get(program, store=False):
        if program.adjoint_hash not in libs:
            libs[program.adjoint_hash] = host_library(build_dir, program)
        return libs[program.adjoint_hash]

    return get


def _image_args(cfg, pix0, n, want_color):
    return (cfg.width, cfg.height, pix0, n, cfg.depth_iterations, cfg.near - 0.1, cfg.near,
            cfg.far, int(want_color))


def _ray_args(rays, cfg, want_color):
    return (*(c.data_ptr() for c in rays), rays[0].numel(), cfg.depth_iterations,
            cfg.near - 0.1, cfg.near, cfg.far, int(want_color))


def patch_kernels(monkeypatch, get):
    """Put the host loops of ``get(program)`` in place of the CUDA launches,
    so the kernel entry points of ``raymarch_kernel`` run on CPU tensors.
    Returns the dict that counts the stand-in launches."""
    calls = {"fwd": 0, "bwd": 0, "store_fwd": 0, "store_bwd": 0, "rays_fwd": 0, "rays_bwd": 0,
             "hit_flags": 0, "rays_bwd_with_hit": 0}

    def launch(lib, params, v19, cfg, want_color, pix0=0, local_npix=None, want_store=False):
        n = cfg.width * cfg.height if local_npix is None else local_npix
        out = torch.empty((n, 3) if want_color else (n,))
        args = (params.data_ptr(), v19.data_ptr(), *_image_args(cfg, pix0, n, want_color))
        if not want_store:
            lib.raymarch_fwd_host(*args, out.data_ptr())
            calls["fwd"] += 1
            return out
        store = torch.empty((cfg.depth_iterations, n))
        lib.raymarch_fwd_store_host(*args, out.data_ptr(), store.data_ptr())
        calls["store_fwd"] += 1
        return out, store

    def launch_bwd(lib, params, v19, cfg, want_color, grad, pix0=0, local_npix=None, store=None):
        n = cfg.width * cfg.height if local_npix is None else local_npix
        assert grad.is_contiguous() and grad.shape == ((n, 3) if want_color else (n,))
        out = np.empty(params.numel() + 19, np.float64)
        args = (params.data_ptr(), v19.data_ptr(), *_image_args(cfg, pix0, n, want_color),
                grad.data_ptr())
        if store is None:
            lib.raymarch_bwd_host(*args, out.ctypes.data)
            calls["bwd"] += 1
        else:
            assert store.is_contiguous() and store.shape == (cfg.depth_iterations, n)
            lib.raymarch_bwd_store_host(*args, store.data_ptr(), out.ctypes.data)
            calls["store_bwd"] += 1
        return torch.from_numpy(out.astype(np.float32))

    def launch_rays(lib, params, rays, cfg, want_color, want_hit=False):
        n = rays[0].numel()
        assert all(c.is_contiguous() and c.shape == (n,) for c in rays)
        assert want_color or not want_hit
        out = torch.empty((n, 3) if want_color else (n,))
        hit = torch.empty(n, dtype=torch.bool) if want_hit else None
        lib.raymarch_rays_fwd_host(params.data_ptr(), *_ray_args(rays, cfg, want_color),
                                   out.data_ptr(), None if hit is None else hit.data_ptr())
        calls["rays_fwd"] += 1
        calls["hit_flags"] += int(want_hit)
        return (out, hit) if want_hit else out

    def launch_rays_bwd(lib, params, rays, cfg, want_color, grad, hit=None, want_depths=False):
        n = rays[0].numel()
        assert grad.is_contiguous() and grad.shape == ((n, 3) if want_color else (n,))
        assert hit is None or (want_color and hit.dtype == torch.bool and hit.shape == (n,))
        g_rays = torch.empty((6, n))
        depths = torch.empty(n) if want_depths else None
        out = np.empty(params.numel(), np.float64)
        lib.raymarch_rays_bwd_host(params.data_ptr(), *_ray_args(rays, cfg, want_color),
                                   grad.data_ptr(), None if hit is None else hit.data_ptr(),
                                   g_rays.data_ptr(), None if depths is None else depths.data_ptr(),
                                   out.ctypes.data)
        calls["rays_bwd"] += 1
        calls["rays_bwd_with_hit"] += int(hit is not None)
        g_params = torch.from_numpy(out.astype(np.float32))
        return (g_params, g_rays, depths) if want_depths else (g_params, g_rays)

    for name, fn in (("launch", launch), ("launch_bwd", launch_bwd),
                     ("launch_rays", launch_rays), ("launch_rays_bwd", launch_rays_bwd)):
        monkeypatch.setattr(rk, name, fn)
    monkeypatch.setattr(rk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(rk, "_check_cuda_float32", lambda *a, **k: None)
    for name in ("load", "load_bwd", "load_rays", "load_rays_bwd"):
        monkeypatch.setattr(build, name, get)
    return calls
