"""Rays given as arrays: the port's plain path and its ray-batch kernels.

Three programs are held against each other on the same seeded rays (numpy),
none of them a camera's: ``render_rays`` / ``render_depth_rays`` of the port
(op by op in IEEE float32), the JAX package's jnp path, and its Pallas
ray-batch kernel ``render_rays_fused`` (interpret mode on the CPU), which is
what the port's CUDA kernel replaces. Then the kernel's own per-ray code,
``shade_ray`` and ``pullback_ray`` of ``csrc/``, built with g++ and put in
place of the two launches inside ``_RenderRays``, so the wrapper's plumbing
(flattening, stride-0 components, the shape of the output and of the ray
cotangents) runs too.

Tolerances. Values between two programs: ``torch_parity``'s contracts for
depth (max-rel 1e-3, median 1e-5) and RGB (max 2e-2), with the RGB median at
5e-4 where the contract for frames has 1e-4: nearly all of these rays hit, so
no sky rays (which agree exactly) pull the median down, and a hit ray's
shading carries the ~1e-4 noise of the eps=1e-5 normal (measured up to 1.1e-4
against the JAX kernel, ``pytest -s``). Between the host build and the plain
path, which run the same IEEE operations: depth rtol 1e-4. Gradients: as in ``test_torch_kernel_bwd_host.py``. Depth
gradients against the plain path are the same operations (rtol 1e-4, atol
1e-5 for the leaves and per-ray cotangents). RGB gradients and every
comparison with JAX add an absolute term of 1e-2 of the largest reference
entry, because the eps=1e-5 normal hands the six taps cotangents ~1/(2e-5)
times the ray's that cancel in pairs, and each float32 program loses an ulp
of that in its own order; for a single ray's cotangent that noise is not
averaged over a frame, so the per-ray comparison is also held by its median
(at most 1e-3 of the largest entry).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.render import raymarch as jrm
from sdfkit_tpu.render.pallas import raymarch_kernel as jrk
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig, render_depth_rays, render_rays
from sdfkit_tpu_torch.utils.camera import camera_rays
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

CFG = RenderConfig(8, 8)  # the ray kernels read only the march settings
JCFG = jrm.RenderConfig(width=8, height=8)
BATCHES = {"1d": (97,), "2d": (7, 13)}


def assert_ray_rgb_close(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    print(f"rgb: max {d.max():.2e}, median {np.median(d):.2e}")
    assert d.max() < 2e-2, float(d.max())
    assert np.median(d) <= 5e-4, float(np.median(d))


def plain(texpr, ro, rd, want_color):
    with torch.no_grad():
        fn = render_rays if want_color else render_depth_rays
        return fn(texpr, tp.torch_v3(ro), tp.torch_v3(rd), CFG).numpy()


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("name", ["union", "repeat_xy", "sphere_repeat"])
def test_plain_rays_match_the_jax_kernel_and_the_jnp_path(name, batch):
    jexpr, texpr = tp.build(name)
    ro, rd = tp.rays(BATCHES[batch], seed=11)
    jro, jrd = tp.jax_v3(ro), tp.jax_v3(rd)
    depth = plain(texpr, ro, rd, False)
    rgb = plain(texpr, ro, rd, True)
    assert depth.shape == BATCHES[batch] and rgb.shape == (*BATCHES[batch], 3)
    tp.assert_depth_close(depth, np.asarray(jrk.render_depth_rays_fused(jexpr, jro, jrd, JCFG)))
    tp.assert_depth_close(depth, np.asarray(jrm.render_depth_rays(jexpr, jro, jrd, JCFG)))
    assert_ray_rgb_close(rgb, np.asarray(jrk.render_rays_fused(jexpr, jro, jrd, JCFG)))
    assert_ray_rgb_close(rgb, np.asarray(jrm.render_rays(jexpr, jro, jrd, JCFG)))


# -- the kernel's per-ray code, through the wrapper ---------------------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("rays_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    return patch_kernels(monkeypatch, host_libs)


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("name", ["union", "repeat_indexed", "sphere_repeat"])
def test_ray_kernel_body_matches_the_plain_path(host_kernels, name, batch):
    _, texpr = tp.build(name)
    ro, rd = tp.rays(BATCHES[batch], seed=5)
    with torch.no_grad():
        depth = rk.render_depth_rays_kernel(texpr, tp.torch_v3(ro), tp.torch_v3(rd), CFG).numpy()
        rgb = rk.render_rays_kernel(texpr, tp.torch_v3(ro), tp.torch_v3(rd), CFG).numpy()
    assert host_kernels["rays_fwd"] == 2
    assert depth.shape == BATCHES[batch] and rgb.shape == (*BATCHES[batch], 3)
    np.testing.assert_allclose(depth, plain(texpr, ro, rd, False), rtol=1e-4)
    assert_ray_rgb_close(rgb, plain(texpr, ro, rd, True))


def test_camera_rays_with_stride_zero_origins_equal_the_image_kernel_body(host_kernels):
    """``camera_rays`` hands out expanded (stride-0) origins; the wrapper
    copies what is not contiguous. The ray kernel on a camera's rays is the
    image kernel's march on rays that torch made instead of the kernel: depth
    at rtol 1e-4, RGB by the small-frame contract."""
    _, texpr = tp.build("sphere_repeat")
    cfg = RenderConfig(40, 24)
    view = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    with torch.no_grad():
        ro, rd = camera_rays(cfg.width, cfg.height, view)
        assert ro.x.stride() == (0, 0)
        depth = rk.render_depth_rays_kernel(texpr, ro, rd, cfg).numpy()
        rgb = rk.render_rays_kernel(texpr, ro, rd, cfg).numpy()
        image_depth = rk.render_depth_image_kernel(texpr, view, cfg).numpy()
        image_rgb = rk.render_image_kernel(texpr, view, cfg).numpy()
    np.testing.assert_allclose(depth, image_depth, rtol=1e-4)
    tp.assert_rgb_close(rgb, image_rgb)


def t_loss(img, want_color):
    if want_color:
        return (img ** 2).sum()
    return (torch.where(img < 50.0, img, torch.zeros_like(img)) ** 2).sum()


def j_loss(img, want_color):
    if want_color:
        return jnp.sum(img ** 2)
    return jnp.sum(jnp.where(img < 50.0, img, 0.0) ** 2)


def port_ray_grads(texpr, ro, rd, want_color, kernel, cfg=CFG):
    """(leaf gradients, d loss / d ro, d loss / d rd) through the port."""
    for p in st.leaves(texpr):
        p.grad = None
    tro, trd = tp.torch_v3(ro, True), tp.torch_v3(rd, True)
    if kernel:
        fn = rk.render_rays_kernel if want_color else rk.render_depth_rays_kernel
    else:
        fn = render_rays if want_color else render_depth_rays
    t_loss(fn(texpr, tro, trd, cfg), want_color).backward()
    stack = lambda v: np.stack([c.grad.numpy() for c in (v.x, v.y, v.z)], axis=-1)
    return tp.leaf_grads(texpr), stack(tro), stack(trd)


def jax_ray_grads(jexpr, ro, rd, want_color, iters=None):
    """The same through ``jax.vjp`` of the fused entry point, whose backward
    is the jnp path (``_fused_bwd``); ``iters`` march iterations (the
    config's default if None)."""
    fn = jrk.render_rays_fused if want_color else jrk.render_depth_rays_fused
    jcfg = JCFG if iters is None else jrm.RenderConfig(width=8, height=8, depth_iterations=iters)
    loss = lambda s, o, d: j_loss(fn(s, o, d, jcfg), want_color)
    gs, go, gd = jax.grad(loss, argnums=(0, 1, 2))(jexpr, tp.jax_v3(ro), tp.jax_v3(rd))
    stack = lambda v: np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], axis=-1)
    return tp.jax_leaf_grads(gs), stack(go), stack(gd)


def assert_ray_grads_close(got, want, exact_program):
    (leaves, g_ro, g_rd), (ref_leaves, ref_ro, ref_rd) = got, want
    largest = max(float(np.abs(b).max()) for b in ref_leaves)
    rtol, atol = (1e-4, 1e-5) if exact_program else (2e-3, 1e-5 + 1e-2 * largest)
    for i, (a, b) in enumerate(zip(leaves, ref_leaves)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"leaf {i}")
    for name, a, b in (("ro", g_ro, ref_ro), ("rd", g_rd, ref_rd)):
        assert a.shape == b.shape and np.isfinite(a).all()
        scale = float(np.abs(b).max())
        err = np.abs(a - b)
        print(f"{name}: largest error {err.max() / scale:.2e}, median {np.median(err) / scale:.2e} "
              f"of the largest entry")
        if exact_program:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 + 1e-6 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5 + 1e-2 * scale, err_msg=name)
            assert np.median(err) <= 1e-3 * scale


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("name,batch", [("union", "1d"), ("repeat_indexed", "2d"),
                                        ("sphere_repeat", "1d")])
def test_ray_pullback_matches_autograd_and_jax(host_kernels, name, batch, want_color):
    """Every scene leaf, ``ro`` and ``rd``, through ``_RenderRays``."""
    jexpr, texpr = tp.build(name)
    ro, rd = tp.rays(BATCHES[batch], seed=7)
    got = port_ray_grads(texpr, ro, rd, want_color, kernel=True)
    assert (host_kernels["rays_fwd"], host_kernels["rays_bwd"]) == (1, 1)
    assert got[1].shape == (*BATCHES[batch], 3)
    assert_ray_grads_close(got, port_ray_grads(texpr, ro, rd, want_color, kernel=False),
                           exact_program=not want_color)
    assert_ray_grads_close(got, jax_ray_grads(jexpr, ro, rd, want_color), exact_program=False)


def test_broadcast_origin_gets_the_summed_cotangent(host_kernels):
    """One origin shared by every ray (``expand``, stride 0): the kernel
    writes a cotangent per ray and autograd sums it back onto the origin."""
    _, texpr = tp.build("union")
    _, rd = tp.rays(33, seed=3)
    origin = torch.tensor([0.1, -0.2, 5.0], requires_grad=True)
    ro = st.V3(*(origin[k].expand(33) for k in range(3)))
    t_loss(rk.render_depth_rays_kernel(texpr, ro, tp.torch_v3(rd), CFG), False).backward()
    got = origin.grad.numpy().copy()
    origin.grad = None
    ro = st.V3(*(origin[k].expand(33) for k in range(3)))
    t_loss(render_depth_rays(texpr, ro, tp.torch_v3(rd), CFG), False).backward()
    np.testing.assert_allclose(got, origin.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_ray_wrappers_raise_on_cpu_tensors_and_mismatched_shapes():
    _, texpr = tp.build("union")
    ro, rd = tp.rays(8, seed=1)
    launches = (rk.RAYS_LAUNCHES, rk.RAYS_BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_rays_kernel(texpr, tp.torch_v3(ro), tp.torch_v3(rd), CFG)
    with pytest.raises(ValueError, match="CUDA"):
        rk.launch_rays(None, torch.zeros(5), [torch.zeros(4)] * 6, CFG, True)
    with pytest.raises(ValueError, match="CUDA"):
        rk.launch_rays_bwd(None, torch.zeros(5), [torch.zeros(4)] * 6, CFG, True,
                           torch.zeros(4, 3))
    meta = lambda a: st.V3(*(torch.empty(a.shape[:-1], device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_depth_rays_kernel(texpr, meta(ro), meta(rd), CFG)
    assert (rk.RAYS_LAUNCHES, rk.RAYS_BWD_LAUNCHES) == launches


def test_mismatched_ray_shapes_raise(host_kernels):
    _, texpr = tp.build("union")
    ro, rd = tp.rays(8, seed=1)
    short = tp.torch_v3(rd[:5])
    with pytest.raises(ValueError, match="shape"):
        rk.render_rays_kernel(texpr, tp.torch_v3(ro), short, CFG)
