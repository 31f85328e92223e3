"""The ray-batch pullback as a tangent march, and the forward's hit flag.

``tangent_pullback_ray`` (``csrc/raymarch_bwd.cuh``) carries the derivatives
of the depth along the march and pulls the final shade back once; the image
pullback ``pullback_ray`` replays the march and sweeps it backward. Both are
built with g++ (``tests/torch_host.py``) and held against each other, against
autograd of the port's plain path and against ``jax.grad`` of the JAX
package's fused ray path (whose backward is the jnp path, ``_fused_bwd``), at
1, 2, 40, 65 and 130 iterations, RGB and depth.

Tolerances, as ``test_torch_rays.py`` states them. The tangent march against
the replay, and depth gradients against the plain path, run the same IEEE
operations (the march's terms are associated the other way): rtol 1e-4, atol
1e-5 for the leaves, plus 1e-6 of the largest entry for the per-ray
cotangents. RGB gradients against the plain path and every comparison with
JAX: rtol 2e-3 and 1e-2 of the largest reference entry (the eps=1e-5 normal's
tap noise), the per-ray median at most 1e-3 of it.

The hit flag that the ray-batch forward writes (``shade_ray<..., WANT_HIT>``)
must be the backward's own sky test, ray for ray, and the march the
backward walks (each step's distance from ``sdf_dist_unit``) the forward's
(``sdf_dist``), bit for bit: both are checked on every parity scene. On the
host that holds by construction (g++ contracts no multiply-add); on the card
``chip_smoke.py`` counts the rays whose depths differ.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params
from sdfkit_tpu_torch.utils.camera import camera_rays
from test_torch_kernel_host import SHIM, _gxx
from test_torch_rays import assert_ray_grads_close, jax_ray_grads, port_ray_grads
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

ITERS = [1, 2, 40, 65, 130]
N_RAYS = 61


def scene_for(iters):
    """A union that some of the rays miss; from 65 iterations on a plane that
    every ray hits (a ray that misses doubles its depth each step and leaves
    float32 by step 70, in every program)."""
    return "union" if iters <= 40 else "plane_xy"


def cfg_for(iters):
    return RenderConfig(8, 8, depth_iterations=iters)


def ray_tensors(ro, rd):
    return [torch.from_numpy(np.ascontiguousarray(a[..., k])) for a in (ro, rd) for k in range(3)]


def cotangent(n, want_color, seed=3):
    g = np.random.default_rng(seed).standard_normal((n, 3) if want_color else (n,))
    return torch.from_numpy(g.astype(np.float32))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("tangent_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    return patch_kernels(monkeypatch, host_libs)


def both_pullbacks(lib, texpr, ro, rd, cfg, want_color, grad):
    """(leaves, (6, n) ray cotangents) of the tangent march and of the
    replay, each loop summing its rays' parameter shares in float64."""
    params = flat_params(texpr).detach().contiguous()
    rays = ray_tensors(ro, rd)
    args = (params.data_ptr(), *(c.data_ptr() for c in rays), len(ro), cfg.depth_iterations,
            cfg.near - 0.1, cfg.near, cfg.far, int(want_color), grad.data_ptr())
    out = {}
    for name in ("tangent", "replay"):
        g_rays = torch.empty((6, len(ro)))
        sums = np.empty(params.numel(), np.float64)
        if name == "tangent":
            lib.raymarch_rays_bwd_host(*args, None, g_rays.data_ptr(), None, sums.ctypes.data)
        else:
            lib.raymarch_rays_bwd_replay_host(*args, g_rays.data_ptr(), sums.ctypes.data)
        out[name] = (sums, g_rays.numpy())
    return out["tangent"], out["replay"]


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("iters", ITERS)
def test_tangent_march_matches_the_replay_pullback(host_libs, iters, want_color):
    """``pullback_ray`` (replay, unit-form sweep; the image backward's, and
    the ray-batch backward's before the tangent march) and the tangent march on the same rays and cotangents: the
    same terms, summed in another order. A sky ray gets exactly zero from
    both."""
    _, texpr = tp.build(scene_for(iters))
    cfg = cfg_for(iters)
    ro, rd = tp.rays(N_RAYS, seed=29)
    grad = cotangent(N_RAYS, want_color)
    lib = host_libs(compile_scene(texpr))
    (t_sums, t_rays), (r_sums, r_rays) = both_pullbacks(lib, texpr, ro, rd, cfg, want_color, grad)
    assert np.isfinite(t_sums).all() and np.isfinite(t_rays).all()
    assert np.abs(t_sums).max() > 0 and np.abs(t_rays).max() > 0
    np.testing.assert_allclose(t_sums, r_sums, rtol=1e-4, atol=1e-5)
    scale = float(np.abs(r_rays).max())
    np.testing.assert_allclose(t_rays, r_rays, rtol=1e-4, atol=1e-5 + 1e-6 * scale)
    sky = ~np.abs(r_rays).any(axis=0)
    np.testing.assert_array_equal(t_rays[:, sky], 0.0)
    if want_color and iters == 40:
        assert 0 < sky.sum() < N_RAYS  # the union's silhouette cuts through the rays


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("iters", ITERS)
def test_ray_pullback_matches_autograd_and_jax_at_every_iteration_count(host_kernels, iters,
                                                                         want_color):
    """Through ``_RenderRays`` (the forward keeps its hit flags in RGB, and
    the pullback skips the rays they mark as misses), every leaf, ``ro`` and
    ``rd``: against autograd of the plain path and ``jax.grad`` of the
    fused ray path."""
    jexpr, texpr = tp.build(scene_for(iters))
    cfg = cfg_for(iters)
    ro, rd = tp.rays(N_RAYS, seed=7)
    got = port_ray_grads(texpr, ro, rd, want_color, kernel=True, cfg=cfg)
    assert (host_kernels["rays_fwd"], host_kernels["rays_bwd"]) == (1, 1)
    assert host_kernels["hit_flags"] == host_kernels["rays_bwd_with_hit"] == int(want_color)
    assert_ray_grads_close(got, port_ray_grads(texpr, ro, rd, want_color, kernel=False, cfg=cfg),
                           exact_program=not want_color)
    assert_ray_grads_close(got, jax_ray_grads(jexpr, ro, rd, want_color, iters=iters),
                           exact_program=False)


@pytest.mark.parametrize("name", ["union", "repeat_indexed", "sphere_repeat"])
def test_the_hit_flag_skips_exactly_the_rays_that_add_nothing(host_libs, host_kernels, name):
    """``launch_rays_bwd`` with the forward's flags and without them:
    bit-identical parameter sums, ray cotangents and depths where a ray was
    marched; a flagged miss costs no march (its depth is NaN) and gets a zero
    cotangent."""
    _, texpr = tp.build(name)
    ro, rd = tp.rays(N_RAYS, seed=13)
    cfg = cfg_for(40)
    program = compile_scene(texpr)
    params = flat_params(texpr).detach().contiguous()
    rays = ray_tensors(ro, rd)
    lib = host_libs(program)
    out, hit = rk.launch_rays(lib, params, rays, cfg, True, want_hit=True)
    grad = cotangent(N_RAYS, True)
    flagged = rk.launch_rays_bwd(lib, params, rays, cfg, True, grad, hit=hit, want_depths=True)
    marched = rk.launch_rays_bwd(lib, params, rays, cfg, True, grad, want_depths=True)
    assert (host_kernels["hit_flags"], host_kernels["rays_bwd_with_hit"]) == (1, 1)
    assert hit.dtype == torch.bool and 0 < int(hit.sum()) < N_RAYS
    sky = out.eq(torch.tensor([0.5, 0.75, 1.0])).all(-1)
    assert torch.equal(~hit, sky)
    np.testing.assert_array_equal(flagged[0].numpy(), marched[0].numpy())
    np.testing.assert_array_equal(flagged[1].numpy(), marched[1].numpy())
    assert bool(flagged[1][:, ~hit].eq(0).all()) and bool(flagged[2][~hit].isnan().all())
    np.testing.assert_array_equal(flagged[2][hit].numpy(), marched[2][hit].numpy())
    assert bool(marched[2].isfinite().all())


def test_the_hit_flags_are_kept_only_where_autograd_records(host_kernels):
    _, texpr = tp.build("union")
    ro, rd = tp.rays(N_RAYS, seed=5)
    with torch.no_grad():
        rk.render_rays_kernel(texpr, tp.torch_v3(ro), tp.torch_v3(rd), cfg_for(40))
    assert (host_kernels["rays_fwd"], host_kernels["hit_flags"]) == (1, 0)
    for want_color in (False, True):
        port_ray_grads(texpr, ro, rd, want_color, kernel=True, cfg=cfg_for(40))
    assert (host_kernels["rays_fwd"], host_kernels["rays_bwd"]) == (3, 2)
    assert host_kernels["hit_flags"] == host_kernels["rays_bwd_with_hit"] == 1


def test_a_depth_render_has_no_hit_flag():
    """Every ray of a depth render has a gradient: the wrapper refuses the
    flag before it looks at the tensors."""
    with pytest.raises(ValueError, match="colour render"):
        rk.launch_rays(None, torch.zeros(5), [torch.zeros(4)] * 6, cfg_for(40), False,
                       want_hit=True)


# -- the flag against the backward's sky test, the two distances ---------------

FLAG_LOOP = """
#include "raymarch_bwd.cuh"

// Per ray: the forward's hit flag; whether the tangent march's final shade
// found a hit (final_shade_vjp's sky test); the depth before the final step
// of the forward's march and of the tangent march.
extern "C" void flags_host(const float* P, const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz, int n, int iters,
                           float depth0, float near_, float far_, unsigned char* hit,
                           unsigned char* shaded, float* fwd_depth, float* bwd_depth) {
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  const float g[3] = {1.0f, 1.0f, 1.0f};
  for (int i = 0; i < n; ++i) {
    const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
    float rgb[3], acc[SDF_N_PARAMS + 1] = {0.0f};
    shade_ray<true, false, true>(r, P, a, rgb, nullptr, 0, hit + i);
    RayGrad gr;
    shaded[i] = tangent_pullback_ray<true>(r, P, a, g, acc, gr, bwd_depth[i]) ? 1 : 0;
    fwd_depth[i] = march_depth(r, P, a);
  }
}

// The distance of sdf_dist and the one sdf_dist_unit returns, at n points.
extern "C" void dists_host(const float* P, const float* pts, int n, float* dist, float* unit) {
  for (int i = 0; i < n; ++i) {
    float ux, uy, uz, uP[kSdfNSlots];
    dist[i] = sdf_dist(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], P);
    unit[i] = sdf_dist_unit(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], P, &ux, &uy, &uz, uP);
  }
}
"""


@pytest.fixture(scope="module")
def flag_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    build_dir = tmp_path_factory.mktemp("flags_host")
    libs = {}

    def get(program):
        if program.adjoint_hash not in libs:
            src = build_dir / f"scene_{program.adjoint_hash}.cc"
            src.write_text(SHIM + program.source + program.adjoint_source + FLAG_LOOP)
            lib = _gxx(src, src.with_suffix(".so"))
            p = ctypes.c_void_p
            lib.flags_host.argtypes = ([p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                                       + [p] * 4)
            lib.dists_host.argtypes = [p, p, ctypes.c_int, p, p]
            libs[program.adjoint_hash] = lib
        return libs[program.adjoint_hash]

    return get


@pytest.mark.parametrize("name", tp.NAMES)
def test_hit_flag_is_the_backwards_sky_test_and_the_marches_agree(flag_libs, name):
    """On a 24x16 camera frame and seeded rays that are no camera's: the
    forward's hit flag equals ``final_shade_vjp``'s sky test after the
    tangent march on every ray, the two marches end at the same depth bit
    for bit, and ``sdf_dist_unit``'s distance is ``sdf_dist``'s at 4096
    seeded points."""
    _, texpr = tp.build(name)
    lib = flag_libs(compile_scene(texpr))
    params = flat_params(texpr).detach().contiguous()
    cfg = RenderConfig(24, 16)
    with torch.no_grad():
        cro, crd = camera_rays(cfg.width, cfg.height, st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0),
                                                                 (0.0, 1.0, 0.0)))
    cam = [np.broadcast_to(c.numpy(), (cfg.height, cfg.width)).reshape(-1)
           for c in (cro.x, cro.y, cro.z, crd.x, crd.y, crd.z)]
    sro, srd = tp.rays(257, seed=31)
    comps = [torch.from_numpy(np.concatenate([c, s]).astype(np.float32))
             for c, s in zip(cam, [*sro.T, *srd.T])]
    n = comps[0].numel()
    hit, shaded = torch.empty(n, dtype=torch.uint8), torch.empty(n, dtype=torch.uint8)
    fwd_depth, bwd_depth = torch.empty(n), torch.empty(n)
    lib.flags_host(params.data_ptr(), *(c.data_ptr() for c in comps), n, cfg.depth_iterations,
                   cfg.near - 0.1, cfg.near, cfg.far, hit.data_ptr(), shaded.data_ptr(),
                   fwd_depth.data_ptr(), bwd_depth.data_ptr())
    np.testing.assert_array_equal(hit.numpy(), shaded.numpy())
    assert set(np.unique(hit.numpy())) <= {0, 1}
    np.testing.assert_array_equal(fwd_depth.numpy(), bwd_depth.numpy())
    pts = np.random.default_rng(37).uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    dist, unit = torch.empty(4096), torch.empty(4096)
    lib.dists_host(params.data_ptr(), pts.ctypes.data, 4096, dist.data_ptr(), unit.data_ptr())
    np.testing.assert_array_equal(dist.numpy(), unit.numpy())
