"""The depth-history handoff between the forward and the backward kernel.

The forward's ``WANT_STORE`` form writes every step's depth and the backward's
``HAS_STORE`` form reads them in place of its replay of the march
(``csrc/raymarch_fwd.cuh`` ``march_depth``, ``csrc/raymarch_bwd.cuh``
``pullback_ray``). Both are built with g++ here and held against

* ``march_history``, the plain version (the same IEEE operations: rtol 1e-4);
* depth renders: row ``i >= 1`` of the store is the depth after ``i`` steps,
  which is what ``render_depth`` with ``depth_iterations=i`` returns, bit for
  bit from the same code;
* the JAX package's ``_pallas_render_image_flat(..., want_store=True)`` and
  ``_pallas_render_image_bwd(..., store)``, called directly in interpret mode
  (nothing in the JAX package calls them: its ``custom_vjp``s pass
  ``store=None``). Their layout is the TPU kernel's: the store is
  ``(n, rows, 128)`` with ``rows`` padded to the forward's 256-row tiles, and
  the cotangent is packed to those rows (``_pack_cotangent(rows=)``). Two
  programs: the store by ``torch_parity``'s depth contract row by row, the
  gradients by the bounds of ``test_torch_kernel_bwd_host.py``;
* the replay pullback: handed the forward's own store, the store-fed pullback
  runs the same operations on the same depths, so the two are equal bit for
  bit (the host loops sum the same float32 values in float64).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.render import raymarch as jrm
from sdfkit_tpu.render.pallas import raymarch_kernel as jrk
from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig, march_history
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params
from sdfkit_tpu_torch.utils.camera import camera_rays
from test_torch_kernel_bwd_host import assert_grads_close
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

VIEW = ((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
SCENES = [("union", 24, 16), ("sphere_repeat", 17, 13)]


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("handoff_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    return patch_kernels(monkeypatch, host_libs)


def launch_args(texpr, cfg):
    program = compile_scene(texpr)
    params = flat_params(texpr).detach().contiguous()
    return program, params, rk.view19(st.look_at(*VIEW), cfg)


def forward_with_store(texpr, cfg, want_color, pix0=0, local_npix=None):
    program, params, v19 = launch_args(texpr, cfg)
    return rk.launch(build.load(program, store=True), params, v19, cfg, want_color, pix0,
                     local_npix, want_store=True)


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("name,w,h", SCENES)
def test_store_matches_march_history_and_leaves_the_frame_alone(host_kernels, name, w, h,
                                                                want_color):
    _, texpr = tp.build(name)
    cfg = RenderConfig(w, h)
    out, store = forward_with_store(texpr, cfg, want_color)
    assert host_kernels["store_fwd"] == 1
    assert store.shape == (cfg.depth_iterations, w * h)
    with torch.no_grad():
        ro, rd = camera_rays(w, h, st.look_at(*VIEW))
        history = march_history(texpr, ro, rd, cfg).reshape(cfg.depth_iterations, -1)
    np.testing.assert_allclose(store.numpy(), history.numpy(), rtol=1e-4)
    assert float(store[0].min()) == float(store[0].max()) == np.float32(cfg.near - 0.1)
    program, params, v19 = launch_args(texpr, cfg)
    plain_out = rk.launch(build.load(program), params, v19, cfg, want_color)
    np.testing.assert_array_equal(out.numpy(), plain_out.numpy())


def test_store_rows_are_depth_renders_of_fewer_iterations(host_kernels):
    """Row i >= 1 is the depth after i steps: the depth kernel's output at
    ``depth_iterations=i``, bit for bit; also over a row band."""
    _, texpr = tp.build("sphere_repeat")
    cfg = RenderConfig(17, 13)
    _, store = forward_with_store(texpr, cfg, True)
    program, params, v19 = launch_args(texpr, cfg)
    for i in (1, 20, 39):
        cfg_i = RenderConfig(17, 13, depth_iterations=i)
        depth_i = rk.launch(build.load(program), params, v19, cfg_i, False)
        np.testing.assert_array_equal(store[i].numpy(), depth_i.numpy())
    _, band = forward_with_store(texpr, cfg, True, pix0=4 * 17, local_npix=5 * 17)
    np.testing.assert_array_equal(band.numpy(), store[:, 4 * 17:9 * 17].numpy())


def jax_launch_args(jexpr, cfg):
    jcfg = jrm.RenderConfig(width=cfg.width, height=cfg.height)
    params, treedef, shapes = jrk._flatten_params(jexpr)
    ivp, cam = jrk._view_to_ivp_cam(jnp.asarray(st.look_at(*VIEW).numpy()), jcfg)
    return jcfg, params, (treedef, tuple(shapes)), ivp, cam


@pytest.mark.parametrize("name,w,h", SCENES)
def test_store_matches_the_pallas_kernels_store(host_kernels, name, w, h):
    jexpr, texpr = tp.build(name)
    cfg = RenderConfig(w, h)
    _, store = forward_with_store(texpr, cfg, True)
    jcfg, params, meta, ivp, cam = jax_launch_args(jexpr, cfg)
    rgb, jstore = jrk._pallas_render_image_flat(
        params, ivp, cam, jnp.zeros((1, 1), jnp.int32), meta, jcfg, True, w * h, True)
    n = cfg.depth_iterations
    assert jstore.shape == (n, jrk.BLOCK_ROWS, 128)
    jstore = np.asarray(jstore).reshape(n, -1)[:, :w * h]
    for i in range(n):
        tp.assert_depth_close(store[i].numpy(), jstore[i])


def both_pullbacks(texpr, cfg, want_color, grad):
    """(store-fed, replay) outputs of launch_bwd on one cotangent."""
    program, params, v19 = launch_args(texpr, cfg)
    _, store = forward_with_store(texpr, cfg, want_color)
    fed = rk.launch_bwd(build.load_bwd(program, store=True), params, v19, cfg, want_color, grad,
                        store=store)
    replay = rk.launch_bwd(build.load_bwd(program), params, v19, cfg, want_color, grad)
    return fed.numpy(), replay.numpy()


def cotangent(cfg, want_color, seed=3):
    g = np.random.default_rng(seed).standard_normal(
        (cfg.width * cfg.height, 3) if want_color else (cfg.width * cfg.height,))
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("name,w,h", SCENES)
def test_store_fed_pullback_equals_the_replay(host_kernels, name, w, h, want_color):
    _, texpr = tp.build(name)
    cfg = RenderConfig(w, h)
    fed, replay = both_pullbacks(texpr, cfg, want_color, cotangent(cfg, want_color))
    assert (host_kernels["store_bwd"], host_kernels["bwd"]) == (1, 1)
    assert np.isfinite(fed).all() and np.abs(fed).max() > 0
    np.testing.assert_array_equal(fed, replay)


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_store_fed_pullback_matches_the_pallas_backward_with_a_store(host_kernels, want_color):
    """Against ``_pallas_render_image_bwd(..., store)`` fed the Pallas
    forward's own store: leaves, then the 16 + 3 view scalars."""
    jexpr, texpr = tp.build("union")
    cfg = RenderConfig(24, 16)
    grad = cotangent(cfg, want_color)
    fed, _ = both_pullbacks(texpr, cfg, want_color, grad)
    jcfg, params, meta, ivp, cam = jax_launch_args(jexpr, cfg)
    pix0 = jnp.zeros((1, 1), jnp.int32)
    _, jstore = jrk._pallas_render_image_flat(params, ivp, cam, pix0, meta, jcfg, want_color,
                                              24 * 16, True)
    g_image = jnp.asarray(grad.numpy().reshape((16, 24, 3) if want_color else (16, 24)))
    g_packed = jrk._pack_cotangent(g_image, jcfg, want_color, rows=jstore.shape[1])
    ref = np.asarray(jrk._pallas_render_image_bwd(params, ivp, cam, pix0, g_packed, jstore, meta,
                                                  jcfg, want_color, 24 * 16))[0]
    n = len(ref) - 19
    assert fed.shape == ref.shape
    assert_grads_close(([fed[:n]], fed[n:]), ([ref[:n]], ref[n:]))


def test_a_store_needs_the_library_built_for_it():
    """The checks that come before any launch, on CPU tensors."""
    cfg = RenderConfig(8, 4)
    lib = build.KernelLib(launch=None, path=None, build_seconds=None, registers={},
                          local_memory={}, store=False)
    cuda_like = torch.zeros(5)
    with pytest.raises(ValueError, match="CUDA"):
        rk.launch(lib, cuda_like, torch.zeros(19), cfg, True, want_store=True)
    with pytest.raises(ValueError, match="library built for it"):
        rk._check_store_build(lib, True)
    with pytest.raises(ValueError, match="library built for it"):
        rk._check_store_build(build.KernelLib(None, None, None, {}, {}, store=True), False)


def test_a_store_lifts_the_iteration_limit_of_the_backward(host_kernels):
    """Neither form has a limit: the store-fed form reads every depth from the
    store, the replay keeps one segment of 64 at a time and replays for each.
    At 70 iterations (two segments) the two are equal bit for bit."""
    _, texpr = tp.build("plane_xy")  # every ray hits: a miss would overflow float32 by step 70
    cfg = RenderConfig(8, 6, depth_iterations=70)
    program, params, v19 = launch_args(texpr, cfg)
    out, store = forward_with_store(texpr, cfg, False)
    assert float(out.max()) < 50.0
    grad = cotangent(cfg, False)
    fed = rk.launch_bwd(build.load_bwd(program, store=True), params, v19, cfg, False, grad,
                        store=store)
    assert np.isfinite(fed.numpy()).all() and float(fed.abs().max()) > 0
    replay = rk.launch_bwd(build.load_bwd(program), params, v19, cfg, False, grad)
    np.testing.assert_array_equal(fed.numpy(), replay.numpy())
