"""The backward kernel's per-pixel code and the emitted adjoint, on the host.

``csrc/raymarch_bwd.cuh`` holds host-and-device code with no CUDA header, as
``raymarch_fwd.cuh`` does. Here it is compiled with g++ together with a
scene's emitted forward and adjoint functions, the shim that defines the CUDA
qualifiers away, and a host loop that sums the pixels in float64 (the kernel
sums in float32, block by block). The host functions then stand in for the
two kernel launches inside the port's ``autograd.Function``, so the wrapper's
own plumbing (cotangent layout, the split into leaf and view cotangents, the
view's gradient through ``view19``) is what the tests differentiate.

Gradients are held against autograd of the port's plain path and against
``jax.grad`` of both JAX backends. The tolerances start from the JAX
package's own between its two backends (tests/test_pallas_kernel.py): leaves
rtol 2e-3 / atol 1e-5; the view rtol 5e-2 / atol 1e-3, looser because the
march amplifies ulp-level differences in the linearization point near
silhouettes by (1 + grad d . rd) per step and the view's gradient sums 39
such steps per pixel. Two things widen them here, each by what was measured:

* Depth gradients against the plain path are two IEEE float32 programs with
  the same operations (g++ emits no FMA): measured 1e-6 apart, held at rtol
  1e-4 (leaves) and 5e-3 (view).
* RGB gradients pass through the eps=1e-5 central-difference normal: the six
  taps receive cotangents about 1/(2e-5) times the pixel's, which cancel in
  pairs, and a float32 program loses about an ulp of that (4e-3 per hit
  pixel at a cotangent of 5e4) in an order that differs between programs. So
  any two float32 programs differ by noise that scales with the scene's
  largest gradient, not with each entry: measured up to 3.0e-3 of the largest
  leaf gradient against the plain path and 8.0e-3 against JAX's jnp path
  (where XLA's rewriting of x/size also picks other cells at cell borders;
  its depth gradients differ by up to 2.4e-3 for the same reason). RGB and
  JAX comparisons therefore add an absolute term of 1e-2 (leaves) and 2e-2
  (view) of the largest reference entry. Every comparison prints its measured
  shares (``pytest -s``).
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import (
    RenderConfig,
    render_depth_image_torch,
    render_depth_rays,
    render_image_torch,
    render_rays,
)
from sdfkit_tpu_torch.sdf.compile import PALETTE_UNROLLED_ROWS, compile_scene
from sdfkit_tpu_torch.utils.camera import camera_rays
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """program -> the host-built functions of that scene."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("kernel_bwd_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    """Put the host-built per-pixel code in place of the CUDA launches, so
    ``rk.render_image_kernel`` and its backward run on CPU tensors."""
    return patch_kernels(monkeypatch, host_libs)


# -- the losses of tests/test_pallas_kernel.py, in both packages --------------

def t_loss(img, want_color):
    if want_color:
        return (img ** 2).sum()
    return (torch.where(img < 50.0, img, torch.zeros_like(img)) ** 2).sum()


def j_loss(img, want_color):
    if want_color:
        return jnp.sum(img ** 2)
    return jnp.sum(jnp.where(img < 50.0, img, 0.0) ** 2)


def port_grads(texpr, view, cfg, want_color, backend):
    """(leaf gradients in JAX leaf order, view gradient) of the loss through
    the port: 'kernel' (the host-built kernel bodies) or 'torch' (autograd of
    the plain path)."""
    for p in st.leaves(texpr):
        p.grad = None
    view = view.clone().requires_grad_()
    if backend == "kernel":
        fn = rk.render_image_kernel if want_color else rk.render_depth_image_kernel
    else:
        fn = render_image_torch if want_color else render_depth_image_torch
    t_loss(fn(texpr, view, cfg), want_color).backward()
    return tp.leaf_grads(texpr), view.grad.numpy()


def jax_grads(jexpr, view, cfg, want_color, backend):
    from sdfkit_tpu.render import raymarch as jrm
    from sdfkit_tpu.render.pallas import raymarch_kernel as jrk
    from sdfkit_tpu.utils.camera import camera_rays

    jcfg = jrm.RenderConfig(width=cfg.width, height=cfg.height,
                            depth_iterations=cfg.depth_iterations)

    def loss(s, v):
        if backend == "fused":
            fn = jrk.render_image_fused if want_color else jrk.render_depth_image_fused
            return j_loss(fn(s, v, jcfg), want_color)
        ro, rd = camera_rays(jcfg.width, jcfg.height, v, jcfg.vfov_degrees, jcfg.near, jcfg.far)
        fn = jrm.render_rays if want_color else jrm.render_depth_rays
        return j_loss(fn(s, ro, rd, jcfg), want_color)

    gs, gv = jax.grad(loss, argnums=(0, 1))(jexpr, jnp.asarray(view.numpy()))
    return tp.jax_leaf_grads(gs), np.asarray(gv)


def assert_grads_close(got, want, exact_program=False):
    """``exact_program``: the reference runs the same IEEE operations with no
    cancellation noise (depth mode against the plain path); otherwise the
    absolute term scales with the largest reference entry (module docstring)."""
    (leaves, view), (ref_leaves, ref_view) = got, want
    assert len(leaves) == len(ref_leaves)
    largest = max(float(np.abs(b).max()) for b in ref_leaves)
    print(f"largest error: leaves {max(float(np.abs(a - b).max()) for a, b in zip(leaves, ref_leaves)) / largest:.2e}"
          f" of the largest leaf entry, view {float(np.abs(view - ref_view).max() / np.abs(ref_view).max()):.2e}"
          f" of the largest view entry")
    if exact_program:
        rtol, atol, view_rtol, view_atol = 1e-4, 1e-5, 5e-3, 1e-3
    else:
        rtol, view_rtol = 2e-3, 5e-2
        atol = 1e-5 + 1e-2 * largest
        view_atol = 1e-3 + 2e-2 * float(np.abs(ref_view).max())
    for i, (a, b) in enumerate(zip(leaves, ref_leaves)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"leaf {i}")
    assert np.isfinite(view).all()
    np.testing.assert_allclose(view, ref_view, rtol=view_rtol, atol=view_atol, err_msg="view")


VIEW = ((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


@functools.lru_cache(maxsize=None)
def _union_reference(want_color, backend):
    jexpr, texpr = tp.build("union")
    view = st.look_at(*VIEW)
    cfg = RenderConfig(24, 16)
    if backend == "torch":
        return port_grads(texpr, view, cfg, want_color, "torch")
    return jax_grads(jexpr, view, cfg, want_color, backend)


@pytest.mark.parametrize("reference", ["torch", "jnp", "fused"])
@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_union_scene_all_leaves_and_view(host_kernels, want_color, reference):
    """The union scene of the JAX package's own gradient test, 24x16, seen
    from (-2, 2, 4): every leaf and the 4x4 view, against autograd of the
    plain path and jax.grad of the jnp and the Pallas (interpret) backends."""
    _, texpr = tp.build("union")
    got = port_grads(texpr, st.look_at(*VIEW), RenderConfig(24, 16), want_color, "kernel")
    assert (host_kernels["fwd"], host_kernels["bwd"]) == (1, 1)
    assert_grads_close(got, _union_reference(want_color, reference),
                       exact_program=reference == "torch" and not want_color)


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("name,w,h", [("repeat_xy", 17, 13), ("repeat_indexed", 40, 24),
                                      ("sphere_repeat", 17, 13)])
def test_repeated_scenes_match_the_plain_path_and_jax(host_kernels, name, w, h, want_color):
    """Cell colours at a size no tile divides, the palette (its cotangent
    goes to a run-time row) and the SphereRepeat structure."""
    jexpr, texpr = tp.build(name)
    view = st.look_at(*VIEW)
    cfg = RenderConfig(w, h)
    got = port_grads(texpr, view, cfg, want_color, "kernel")
    assert_grads_close(got, port_grads(texpr, view, cfg, want_color, "torch"),
                       exact_program=not want_color)
    assert_grads_close(got, jax_grads(jexpr, view, cfg, want_color, "jnp"))


def test_palette_gradient_reaches_the_table(host_kernels):
    _, texpr = tp.build("repeat_indexed")
    leaves, _ = port_grads(texpr, st.look_at(*VIEW), RenderConfig(40, 24), True, "kernel")
    table = leaves[-1]
    assert table.shape == (3, 3) and (np.abs(table) > 0).all()


@pytest.mark.parametrize("rows", [PALETTE_UNROLLED_ROWS, PALETTE_UNROLLED_ROWS + 1, 5500])
def test_a_palette_of_any_size_takes_its_cotangent(host_kernels, rows):
    """A palette's cotangent through the kernel against autograd of the
    plain path: at the last size whose adjoint adds row by row, at the first
    that adds to a run-time row, and at 5,500 rows (16,506 slots, more than
    the constant bank holds)."""
    table = np.random.default_rng(rows).uniform(0.2, 1.0, (rows, 3)).astype(np.float32)
    texpr = st.sphere(0.4).repeat_indexed("xy", (1.125, 1.125), table,
                                          index_fn=lambda x, y, z: x * 37.0 + y)
    view = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(24, 16)
    got = port_grads(texpr, view, cfg, True, "kernel")
    assert host_kernels["bwd"] == 1
    assert_grads_close(got, port_grads(texpr, view, cfg, True, "torch"))
    assert int((np.abs(got[0][-1]).sum(-1) > 0).sum()) >= 10  # rows the frame reads
    # The adjoint's length does not grow with the rows past the unrolled size.
    assert len(compile_scene(texpr).adjoint_source) < 10_000


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_box_seen_from_inside_its_zero_region_is_finite(host_kernels, want_color):
    """Inside the box the exterior term is exactly zero: zero_safe_length's
    double where must select, not multiply, or sqrt'(0) * 0 leaks NaN."""
    texpr = st.box((3.0, 2.5, 4.0), color=(0.3, 0.6, 0.9))
    view = st.look_at((0.2, 0.1, 1.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(16, 16)
    got = port_grads(texpr, view, cfg, want_color, "kernel")
    assert all(np.isfinite(g).all() for g in got[0]) and np.isfinite(got[1]).all()
    assert_grads_close(got, port_grads(texpr, view, cfg, want_color, "torch"),
                       exact_program=not want_color)


def test_color_gradient_matches_finite_differences(host_kernels):
    """Colour acts smoothly (no silhouette discontinuity), so the kernel's
    gradient must match finite differences tightly (rtol 1e-2)."""
    view = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(16, 16)

    def loss(c):
        s = st.sphere(1.0, color=(c, 0.3, 0.3))
        return s, (rk.render_image_kernel(s, view, cfg) ** 2).mean()

    s, value = loss(0.8)
    value.backward()
    e = 1e-2
    with torch.no_grad():
        fd = (loss(0.8 + e)[1] - loss(0.8 - e)[1]) / (2 * e)
    np.testing.assert_allclose(float(s.rgb.grad[0]), float(fd), rtol=1e-2)


def test_row_band_pullbacks_sum_to_the_frame(host_libs):
    """pix0 and local_npix: the pullbacks of two row bands add up to the
    whole frame's (the multi-device path hands each device one band)."""
    _, texpr = tp.build("union")
    cfg = RenderConfig(24, 16)
    lib = host_libs(compile_scene(texpr))
    params = st.sdf.leaves(texpr)
    params = torch.cat([p.detach().reshape(-1) for p in params]).contiguous()
    v19 = rk.view19(st.look_at(*VIEW), cfg)
    grad = torch.from_numpy(np.random.default_rng(3).standard_normal((16 * 24, 3)).astype(np.float32))

    def band(pix0, n):
        out = np.empty(params.numel() + 19, np.float64)
        lib.raymarch_bwd_host(params.data_ptr(), v19.data_ptr(), 24, 16, pix0, n, 40, 0.9, 1.0,
                              100.0, 1, grad[pix0:pix0 + n].contiguous().data_ptr(),
                              out.ctypes.data)
        return out

    whole = band(0, 16 * 24)
    assert np.isfinite(whole).all() and np.abs(whole).max() > 0
    np.testing.assert_allclose(band(0, 5 * 24) + band(5 * 24, 11 * 24), whole, rtol=1e-12, atol=1e-12)


# -- marches longer than one segment of the kept depths ------------------------
#
# The replay keeps 64 depths (``kSdfHistory`` of ``csrc/raymarch_bwd.cuh``) and
# sweeps a longer march segment by segment, each after a replay of its own; 70
# iterations are two segments (5 + 64 steps), 80 are 15 + 64. The JAX package
# takes any count. The scene is a plane that every ray hits: a ray that
# misses doubles its depth each step and leaves float32 by step 70. It is seen
# from z = 2: the eps=1e-5 taps at a point x carry ulp(x) / 2e-5 of rounding
# into the gradient of the plane's normal, which from z = 5 (points out to
# |x| = 3) puts the plain path and JAX 1.0e-2 of the largest entry apart.

LONG_SIZE = (8, 6)


def long_march_grads(expr, iters, want_color, path, through, rays=None):
    """Gradients of the loss at ``iters`` march iterations: every leaf, then
    the 4x4 view (``path="image"``) or the rays' origins and directions
    (``"rays"``: ``rays``, or the 8x6 camera rays as arrays). ``through`` is ``"kernel"``
    (the host-built kernel bodies behind the autograd nodes), ``"torch"``
    (autograd of the plain path) or ``"jax"`` (``jax.grad`` of the jnp path)."""
    w, h = LONG_SIZE
    view = st.look_at((0.3, 0.2, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(w, h, depth_iterations=iters)
    if path == "image":
        if through == "jax":
            return jax_grads(expr, view, cfg, want_color, "jnp")
        return port_grads(expr, view, cfg, want_color, through)
    if rays is None:
        with torch.no_grad():
            ro, rd = camera_rays(w, h, view)
        ro = np.stack([c.expand(h, w).numpy() for c in (ro.x, ro.y, ro.z)], -1).copy()
        rd = np.stack([c.numpy() for c in (rd.x, rd.y, rd.z)], -1).copy()
    else:
        ro, rd = rays
    if through == "jax":
        from sdfkit_tpu.render import raymarch as jrm

        jcfg = jrm.RenderConfig(width=w, height=h, depth_iterations=iters)
        fn = jrm.render_rays if want_color else jrm.render_depth_rays
        gs, go, gd = jax.grad(lambda s, o, d: j_loss(fn(s, o, d, jcfg), want_color),
                              argnums=(0, 1, 2))(expr, tp.jax_v3(ro), tp.jax_v3(rd))
        g_rays = [np.asarray(c) for v in (go, gd) for c in (v.x, v.y, v.z)]
        return tp.jax_leaf_grads(gs), np.stack(g_rays)
    for q in st.leaves(expr):
        q.grad = None
    tro, trd = tp.torch_v3(ro, True), tp.torch_v3(rd, True)
    if through == "kernel":
        fn = rk.render_rays_kernel if want_color else rk.render_depth_rays_kernel
    else:
        fn = render_rays if want_color else render_depth_rays
    t_loss(fn(expr, tro, trd, cfg), want_color).backward()
    return tp.leaf_grads(expr), np.stack([c.grad.numpy() for v in (tro, trd)
                                          for c in (v.x, v.y, v.z)])


@pytest.mark.parametrize("iters", [70, 80])
@pytest.mark.parametrize("path", ["image", "rays"])
@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_a_march_longer_than_the_kept_depths_differentiates(host_kernels, want_color, path, iters):
    """Through ``_RenderImage`` and ``_RenderRays`` with the host-built kernel
    bodies, against autograd of the plain path, and at 70 iterations against
    the JAX package: the bounds of this module (the second entry is the view's
    gradient or the rays' cotangents)."""
    jexpr, texpr = tp.build("plane_xy")
    got = long_march_grads(texpr, iters, want_color, path, "kernel")
    launched = ("fwd", "bwd") if path == "image" else ("rays_fwd", "rays_bwd")
    assert [host_kernels[k] for k in launched] == [1, 1]
    assert host_kernels["store_fwd"] == host_kernels["store_bwd"] == 0
    assert max(float(np.abs(g).max()) for g in got[0]) > 0 and float(np.abs(got[1]).max()) > 0
    assert_grads_close(got, long_march_grads(texpr, iters, want_color, path, "torch"),
                       exact_program=not want_color)
    if iters == 70:
        assert_grads_close(got, long_march_grads(jexpr, iters, want_color, path, "jax"))


@pytest.mark.parametrize("iters", [65, 66, 129, 130])
def test_segments_of_the_kept_depths_join(host_kernels, iters):
    """One march step more or less than a whole number of segments (64 steps
    are 65 iterations). On a ray that hits, a step's share of the gradient
    falls off geometrically with the steps after it, so the early segments
    would carry nothing. These rays skim a floor at a height of 0.3, nearly
    level: every step advances by about 0.3 and (1 + grad d . rd) is about 1,
    so every step of every segment carries the same share. Depth gradients
    (130 steps end at a depth under 50) against autograd of the plain path."""
    _, texpr = tp.build("plane_xz")  # the floor y = -0.2
    rng = np.random.default_rng(17)
    n = 24
    ro = np.stack([rng.uniform(-1, 1, n), np.full(n, 0.1), np.full(n, 5.0)], -1).astype(np.float32)
    rd = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-2e-3, 2e-3, n), -np.ones(n)], -1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    got = long_march_grads(texpr, iters, False, "rays", "kernel", (ro, rd))
    ref = long_march_grads(texpr, iters, False, "rays", "torch", (ro, rd))
    assert float(np.abs(ref[1]).max()) > 10.0 * iters  # the steps add up; they do not decay
    assert_grads_close(got, ref, exact_program=True)
