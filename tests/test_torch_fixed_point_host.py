"""The forwards' exact exit: a march that has reached its bitwise fixed point
stops, and a sky pixel is not shaded, with every output bit unchanged.

``csrc/raymarch_fwd.cuh`` ``march_depth`` runs the march in groups of steps
and leaves it after a group whose last step left the depth bit for bit where
it was (on the card when all the warp's lanes say so; the host runs the same
loop with a ray as a warp of one lane), and ``shade_ray`` writes
the sky's constant for a ray that missed without running the taps. The step
is a function of the depth's bits alone, so neither changes a result. Here
the header's forwards, built with g++ through ``tests/torch_host.py``, are
held bit for bit against a host loop in this file (not in the package): the
forward as it was before, every one of the ``iters - 1`` steps of the same
emitted ``sdf_dist``, every pixel shaded. Depth, RGB, hit flags and the depth
history's rows are compared as bits (so that -0.0 and +0.0, and NaNs, are
told apart):

* on every parity scene and on SphereRepeat at 64x36, at 40, 80 and 130
  iterations, through the image forward (with and without store) and the
  ray-batch forward (the frame's camera rays and rays that are no camera's);
* on SphereRepeat at iteration counts that leave no whole group, exactly
  one, or whole groups and no steps over;
* on rays that start at depth -0.0 and at +0.0, through a scene whose
  distance tells the two signs of zero apart: the first step from -0.0
  lands on +0.0, equal under ``==``, and the march must go on from there;
* on rays whose distance is NaN (a NaN never settles).
"""

import concurrent.futures
import ctypes
import shutil

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch import ops, scenes
from sdfkit_tpu_torch.render.cuda.raymarch_kernel import view19
from sdfkit_tpu_torch.render.raymarch import RenderConfig, settled_steps, warp_march_steps
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params
from sdfkit_tpu_torch.utils.camera import camera_rays
from torch_host import host_library

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

VIEW = ((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
ITERS = (40, 80, 130)
SKY = (0.5, 0.75, 1.0)
_P = ctypes.c_void_p
_IMAGE = [_P] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3 + [ctypes.c_int]
_RAYS = [_P] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_int]

# The forward before the exact exit, for reference: all iters - 1 steps, the
# store written by index, and every pixel shaded, the sky's too (at near).
FULL = """
template <bool WANT_COLOR, bool WANT_STORE, bool WANT_HIT>
static void full_shade_ray(const Ray& r, const float* P, const RenderArgs& a, float* o,
                           float* store, long long stride, unsigned char* hit) {
  float depth = a.depth0;
  for (int i = 0; i < a.iters - 1; ++i) {
    if (WANT_STORE) store[i * stride] = depth;
    depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
  }
  if (WANT_STORE) store[(a.iters - 1) * stride] = depth;
  if (!WANT_COLOR) {
    depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
    o[0] = depth;
    return;
  }
  float cr, cg, cb;
  depth += sdf_eval(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P,
                    &cr, &cg, &cb);
  const bool bg = depth > a.far_;
  if (WANT_HIT) *hit = bg ? 0 : 1;
  const float sd = bg ? a.near_ : depth;
  const float sx = r.ox + r.dx * sd;
  const float sy = r.oy + r.dy * sd;
  const float sz = r.oz + r.dz * sd;
  const float e = 1e-5f;
  float nx = sdf_dist(sx + e, sy, sz, P) - sdf_dist(sx + -e, sy, sz, P);
  float ny = sdf_dist(sx, sy + e, sz, P) - sdf_dist(sx, sy + -e, sz, P);
  float nz = sdf_dist(sx, sy, sz + e, P) - sdf_dist(sx, sy, sz + -e, P);
  safe_normalize(nx, ny, nz);
  float lx = 5.0f - sx;
  float ly = 5.0f - sy;
  float lz = 10.0f - sz;
  safe_normalize(lx, ly, lz);
  const float lambert = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
  if (bg) {
    o[0] = 0.5f;
    o[1] = 0.75f;
    o[2] = 1.0f;
  } else {
    o[0] = cr * lambert + 0.1f;
    o[1] = cg * lambert + 0.1f;
    o[2] = cb * lambert + 0.1f;
  }
}

extern "C" void full_fwd_host(const float* P, const float* view19, int width, int height,
                              int pix0, int local_npix, int iters, float depth0, float near_,
                              float far_, int want_color, float* out, float* store) {
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  for (int i = 0; i < local_npix; ++i) {
    const Ray r = ray_from_index(pix0 + i, view19, a);
    float* o = out + (want_color ? 3 : 1) * (long long)i;
    float* s = store == nullptr ? nullptr : store + i;
    if (want_color && s) full_shade_ray<true, true, false>(r, P, a, o, s, local_npix, nullptr);
    else if (want_color) full_shade_ray<true, false, false>(r, P, a, o, nullptr, 0, nullptr);
    else if (s) full_shade_ray<false, true, false>(r, P, a, o, s, local_npix, nullptr);
    else full_shade_ray<false, false, false>(r, P, a, o, nullptr, 0, nullptr);
  }
}

extern "C" void full_rays_fwd_host(const float* P, const float* ox, const float* oy,
                                   const float* oz, const float* dx, const float* dy,
                                   const float* dz, int n, int iters, float depth0,
                                   float near_, float far_, int want_color, float* out,
                                   unsigned char* hit) {
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  for (int i = 0; i < n; ++i) {
    const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
    if (hit != nullptr) full_shade_ray<true, false, true>(r, P, a, out + 3 * i, nullptr, 0, hit + i);
    else if (want_color) full_shade_ray<true, false, false>(r, P, a, out + 3 * i, nullptr, 0, nullptr);
    else full_shade_ray<false, false, false>(r, P, a, out + i, nullptr, 0, nullptr);
  }
}
"""


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def assert_same_bits(got: torch.Tensor, ref: torch.Tensor, what: str):
    assert got.shape == ref.shape, what
    differ = int((_bits(got) != _bits(ref)).sum())
    assert differ == 0, f"{what}: {differ} of {ref.numel()} values differ in their bits"


def zero_sign_scene():
    """A distance that is +0 where x is +0 and 0.5 where x is -0: a ray from
    an origin with x = -0.0 going toward -x is at x = +0 at depth -0.0 and at
    x = -0.0 at depth +0.0, so its march moves on from +0.0 and not from -0.0."""
    return st.solid(lambda p: ops.maximum(ops.minimum(-1.0 / p.x, 0.5), 0.0))


def all_scenes():
    """name -> the port's scene: the parity scenes and the hero."""
    out = {name: tp.build(name)[1] for name in tp.NAMES}
    out["hero"] = scenes.sphere_repeat_scene()
    out["zero_sign"] = zero_sign_scene()
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name -> (scene, its host library), built in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    build_dir = tmp_path_factory.mktemp("fixed_point_host")
    exprs = all_scenes()

    programs = [compile_scene(expr) for expr in exprs.values()]

    def make(program):
        lib = host_library(build_dir, program, extra=FULL)
        for name, argtypes in (("full_fwd_host", _IMAGE + [_P, _P]),
                               ("full_rays_fwd_host", _RAYS + [_P, _P])):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = argtypes
        return lib

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        libs = dict(zip(exprs, pool.map(make, programs)))
    return {name: (exprs[name], libs[name]) for name in exprs}


def image_args(cfg, depth0):
    return (cfg.width, cfg.height, 0, cfg.width * cfg.height, cfg.depth_iterations,
            np.float32(depth0).item(), cfg.near, cfg.far)


def image_forward(lib, expr, cfg, want_color, store, full, depth0=None, view=VIEW):
    """(out, store or None) of the header's image forward, or of the full loop."""
    n = cfg.width * cfg.height
    params = flat_params(expr).detach().contiguous()
    v19 = view19(st.look_at(*view), cfg)
    out = torch.empty((n, 3) if want_color else (n,))
    rows = torch.empty((cfg.depth_iterations, n)) if store else None
    depth0 = cfg.near - 0.1 if depth0 is None else depth0
    args = (params.data_ptr(), v19.data_ptr(), *image_args(cfg, depth0), int(want_color),
            out.data_ptr())
    if full:
        lib.full_fwd_host(*args, None if rows is None else rows.data_ptr())
    elif store:
        lib.raymarch_fwd_store_host(*args, rows.data_ptr())
    else:
        lib.raymarch_fwd_host(*args)
    return out, rows


def rays_forward(lib, expr, rays, cfg, want_color, want_hit, full, depth0=None):
    """(out, hit or None) of the header's ray-batch forward, or of the full loop."""
    n = rays[0].numel()
    params = flat_params(expr).detach().contiguous()
    out = torch.empty((n, 3) if want_color else (n,))
    hit = torch.empty(n, dtype=torch.uint8) if want_hit else None
    depth0 = cfg.near - 0.1 if depth0 is None else depth0
    args = (params.data_ptr(), *(c.data_ptr() for c in rays), n, cfg.depth_iterations,
            np.float32(depth0).item(), cfg.near, cfg.far, int(want_color), out.data_ptr(),
            None if hit is None else hit.data_ptr())
    (lib.full_rays_fwd_host if full else lib.raymarch_rays_fwd_host)(*args)
    return out, hit


def camera_and_scattered_rays(cfg):
    ro, rd = camera_rays(cfg.width, cfg.height, st.look_at(*VIEW), cfg.vfov_degrees, cfg.near,
                         cfg.far)
    cam = [c.reshape(-1) for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
    sro, srd = tp.rays(64, seed=7)
    other = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (sro, srd) for k in range(3)]
    return [torch.cat([a, b]).contiguous() for a, b in zip(cam, other)]


def assert_forwards_exact(lib, expr, cfg):
    """Every forward of the header against the full loop, bit for bit.
    Returns the full loop's RGB, depth and depth history."""
    for want_color in (True, False):
        kind = "rgb" if want_color else "depth"
        got, _ = image_forward(lib, expr, cfg, want_color, store=False, full=False)
        ref, ref_rows = image_forward(lib, expr, cfg, want_color, store=True, full=True)
        assert_same_bits(got, ref, f"image {kind}")
        got, rows = image_forward(lib, expr, cfg, want_color, store=True, full=False)
        assert_same_bits(got, ref, f"image {kind} with store")
        assert_same_bits(rows, ref_rows, f"store rows of the {kind} forward")
        if want_color:
            rgb, history = ref, ref_rows
        else:
            depth = ref
    rays = camera_and_scattered_rays(cfg)
    for want_color, want_hit in ((True, True), (True, False), (False, False)):
        got, hit = rays_forward(lib, expr, rays, cfg, want_color, want_hit, full=False)
        ref, ref_hit = rays_forward(lib, expr, rays, cfg, want_color, want_hit, full=True)
        assert_same_bits(got, ref, f"rays {'rgb' if want_color else 'depth'}")
        if want_hit:
            assert torch.equal(hit, ref_hit), "hit flags"
    return rgb, depth, history


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name", tp.NAMES)
def test_the_exit_is_exact_on_the_parity_scenes(built, name, iters):
    expr, lib = built[name]
    assert_forwards_exact(lib, expr, RenderConfig(24, 16, depth_iterations=iters))


@pytest.mark.parametrize("iters", ITERS)
def test_the_exit_is_exact_on_sphere_repeat(built, iters):
    expr, lib = built["hero"]
    cfg = RenderConfig(64, 36, depth_iterations=iters)
    rgb, depth, history = assert_forwards_exact(lib, expr, cfg)
    steps = settled_steps(history)
    # Many rays reach their fixed point before the march's last step, and a
    # settled ray's later rows all equal its settled depth.
    assert int((steps < 39).sum()) > cfg.width * cfg.height // 4, steps
    for ray in range(0, cfg.width * cfg.height, 97):
        s = int(steps[ray])
        assert (history[s + 1:, ray] == history[s + 1, ray]).all() if s + 1 < iters else True
    sky = depth > cfg.far
    assert bool(sky.any()) and bool((~sky).any())
    assert (rgb[sky] == torch.tensor(SKY)).all()


@pytest.mark.parametrize("iters", [1, 2, 4, 5, 41])
def test_the_exit_is_exact_at_the_groups_edges(built, iters):
    """March steps in no whole group (1, 2 and 4 iterations: 0, 1 and 3
    steps), in one group and nothing over (5), and in ten groups and nothing
    over (41): the group loop, the steps left over and the rows written
    after an exit meet at every edge."""
    expr, lib = built["hero"]
    assert_forwards_exact(lib, expr, RenderConfig(32, 18, depth_iterations=iters))


@pytest.mark.parametrize("depth0", [-0.0, 0.0], ids=["minus_zero", "plus_zero"])
def test_rays_that_start_at_a_signed_zero(built, depth0):
    expr, lib = built["zero_sign"]
    cfg = RenderConfig(8, 4)
    n = 16
    rng = np.random.default_rng(2)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 0] = -np.abs(d[:, 0]) - 0.1  # toward -x
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = [torch.full((n,), -0.0), torch.zeros(n), torch.zeros(n)]
    rays += [torch.from_numpy(np.ascontiguousarray(d[:, k])) for k in range(3)]
    for want_color, want_hit in ((True, True), (False, False)):
        got, hit = rays_forward(lib, expr, rays, cfg, want_color, want_hit, full=False,
                                depth0=depth0)
        ref, ref_hit = rays_forward(lib, expr, rays, cfg, want_color, want_hit, full=True,
                                    depth0=depth0)
        assert_same_bits(got, ref, f"rays from depth {depth0!r}")
        if want_hit:
            assert torch.equal(hit, ref_hit)
    depth, _ = rays_forward(lib, expr, rays, cfg, False, False, full=True, depth0=depth0)
    # From -0.0 the first step lands on +0.0, equal under ==, and the march
    # moves on from there: the ray ends far from its origin either way.
    assert bool((depth > 1.0).all()), depth
    # The image forward's store holds the signed zeros row by row.
    for want_color in (True, False):
        got, rows = image_forward(lib, expr, cfg, want_color, store=True, full=False,
                                  depth0=depth0, view=((-0.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
                                                       (0.0, 1.0, 0.0)))
        ref, ref_rows = image_forward(lib, expr, cfg, want_color, store=True, full=True,
                                      depth0=depth0, view=((-0.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
                                                           (0.0, 1.0, 0.0)))
        assert_same_bits(got, ref, f"image from depth {depth0!r}")
        assert_same_bits(rows, ref_rows, f"store rows from depth {depth0!r}")


@pytest.mark.parametrize("name", ["sphere", "hero"])
def test_a_ray_whose_distance_is_nan(built, name):
    """A NaN point gives the sphere a NaN distance, and the march a NaN depth
    that never settles; SphereRepeat's distance there is a number (its
    minima and maxima drop a NaN operand) and the march settles."""
    expr, lib = built[name]
    cfg = RenderConfig(8, 4)
    rays = camera_and_scattered_rays(cfg)
    for k in (3, 4, 5):
        rays[k][::5] = float("nan")  # rd: every component of the point, so the distance
    rays[0][1::7] = float("inf")  # ox: an infinite point
    for want_color, want_hit in ((True, True), (True, False), (False, False)):
        got, hit = rays_forward(lib, expr, rays, cfg, want_color, want_hit, full=False)
        ref, ref_hit = rays_forward(lib, expr, rays, cfg, want_color, want_hit, full=True)
        assert_same_bits(got, ref, "rays with NaN distances")
        if want_hit:
            assert torch.equal(hit, ref_hit)
    depth, _ = rays_forward(lib, expr, rays, cfg, False, False, full=True)
    assert bool(torch.isnan(depth[::5]).all()) == (name == "sphere")


def test_settled_steps_and_the_warps_march_steps():
    """``settled_steps`` finds the first step that left a depth's bits where
    they were (a NaN never settles, -0.0 to +0.0 is a move);
    ``warp_march_steps`` gives a warp its slowest ray's steps, rounded up to
    a group and at most iterations - 1."""
    nan, inf = float("nan"), float("inf")
    history = torch.tensor([[0.9, 0.9, 0.9, -0.0, 0.9],
                            [1.0, 2.0, nan, 0.0, inf],
                            [1.0, 3.0, nan, 0.0, inf],
                            [1.0, 3.0, nan, 0.0, inf],
                            [1.0, 3.0, nan, 0.0, inf]])
    steps = settled_steps(history)
    assert steps.tolist() == [1, 2, 4, 1, 1]
    assert warp_march_steps(steps, 5, 1, warp=2).tolist() == [3, 4, 2]
    assert warp_march_steps(steps, 5, 2, warp=2).tolist() == [4, 4, 2]
    assert warp_march_steps(steps, 5, 4, warp=5).tolist() == [4]
