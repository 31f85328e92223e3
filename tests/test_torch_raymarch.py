"""The port's plain PyTorch renderer (CPU): the reference probes, the
committed goldens, parity with the JAX jnp path and with the JAX Pallas
kernel in interpret mode, and the slice as a whole.

Contracts between two programs are in ``torch_parity`` (why: XLA contracts
FMAs and rewrites division by constants under jit; the port does neither).
The depth goldens hold at the repo's own rtol 1e-4.
"""

import pathlib

import numpy as np
import pytest
import torch

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
import torch_parity as tp
from bench import sphere_repeat_scene as jax_sphere_repeat
from sdfkit_tpu_torch import ops, scenes
from sdfkit_tpu_torch.io.png import read_png

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
W, H = 50, 30


def depth_at(img, x, y):
    return float(img[y, x])


def np_render_depth(*args, **kwargs):
    with torch.no_grad():
        return st.render_depth(*args, **kwargs).numpy()


def np_render(*args, **kwargs):
    with torch.no_grad():
        return st.render(*args, **kwargs).numpy()


class TestRenderDepth:
    def test_sphere_depth(self):
        img = np_render_depth(st.sphere(1.0), W, H)
        assert img.shape == (H, W)
        assert abs(depth_at(img, W // 2, H // 2) - 4.0) < 1e-2
        assert depth_at(img, 0, 0) > 9.0

    def test_box_depth(self):
        img = np_render_depth(st.box(1.0), W, H)
        assert abs(depth_at(img, W // 2, H // 2) - 4.0) < 1e-2
        assert depth_at(img, 0, 0) > 9.0

    def test_plane_depth(self):
        img = np_render_depth(st.plane_xy(), W, H)
        assert abs(depth_at(img, W // 2, H // 2) - 5.0) < 1e-2
        assert depth_at(img, 0, 0) < 9.0

    def test_cylinder_repeat_depth(self):
        r = 0.25
        img = np_render_depth(st.cylinder(r, r * 2).repeat_x(4 * r), W, H)
        assert abs(depth_at(img, W // 2, H // 2 - 2) - (5 - r)) < 1e-1
        assert depth_at(img, 0, 0) > 9.0


class TestRender:
    def test_sphere_rgb_shading(self):
        img = np_render(st.sphere(1.0), W, H)
        assert img.shape == (H, W, 3)
        np.testing.assert_allclose(img[0, 0], [0.5, 0.75, 1.0], atol=1e-5)
        c = img[H // 2, W // 2]
        assert c[0] == c[1] == c[2]
        assert 0.1 < c[0] <= 1.2
        assert img[H // 2 - 3, W // 2 + 3, 0] > img[H // 2 + 3, W // 2 - 3, 0]

    def test_colored_render(self):
        img = np_render(st.sphere(1.0, color=(1.0, 0.0, 0.0)), W, H)
        c = img[H // 2, W // 2]
        assert c[0] > 0.5
        np.testing.assert_allclose(c[1], 0.1, atol=1e-5)
        np.testing.assert_allclose(c[2], 0.1, atol=1e-5)

    def test_sphere_repeat_scene(self):
        r = 0.5
        s = st.sphere(r).repeat_xy(
            2.25 * r, 2.25 * r,
            lambda i, p, c, d: st.V3(0.9 - ops.abs(i.x) / 6.0, 0.9 - ops.abs(i.y) / 6.0,
                                     ops.full_like(i.z, 0.9)),
        )
        img = np_render(s, 96, 54, camera_position=(-2, 2, 4))
        assert img.shape == (54, 96, 3)
        assert np.isfinite(img).all()
        assert img[:, :, 2].std() > 0.01

    def test_camera_look_at(self):
        img = np_render_depth(st.sphere(1.0), W, H, view=st.look_at((5, 0, 0), (0, 0, 0), (0, 1, 0)))
        assert abs(depth_at(img, W // 2, H // 2) - 4.0) < 1e-2

    def test_depth_iterations_override(self):
        with torch.no_grad():
            img = st.RayMarcher(W, H, st.sphere(1.0), depth_iterations=5).render_depth().numpy()
        assert 2.0 < depth_at(img, W // 2, H // 2) < 4.05

    def test_grad_of_depth_wrt_radius(self):
        # Autograd through the 40-step plain path: d(center depth)/d(radius) ~ -1.
        s = st.sphere(1.0)
        st.render_depth(s, 9, 9)[4, 4].backward()
        np.testing.assert_allclose(float(s.radius.grad), -1.0, atol=1e-2)

    def test_grad_of_image_loss_is_finite(self):
        s = st.sphere(1.0, color=(0.8, 0.2, 0.4))
        (st.render(s, 16, 16) ** 2).mean().backward()
        assert torch.isfinite(s.radius.grad) and torch.isfinite(s.rgb.grad).all()
        assert float(s.rgb.grad.abs().sum()) > 0


@pytest.mark.parametrize("name,expr", [
    ("sphere", lambda: st.sphere(1.0)),
    ("box", lambda: st.box(1.0)),
    ("plane", lambda: st.plane_xy()),
])
def test_depth_goldens(name, expr):
    golden = np.load(GOLDEN_DIR / f"{name}_depth_50x30.npy")
    np.testing.assert_allclose(np_render_depth(expr(), 50, 30), golden, rtol=1e-4, atol=1e-4)


def _slice_frame():
    return np_render(scenes.sphere_repeat_scene(), 192, 108, camera_position=(-2, 2, 4))


def test_slice_meets_the_rgb_golden():
    # The golden is the JAX jnp path under jit, 8-bit quantized; the port is
    # another program (see torch_parity), so the contract is distributional,
    # and at least 99% of pixels are within the golden's atol 5e-3.
    golden = read_png(GOLDEN_DIR / "sphere_repeat_192x108.png")
    img = np.clip(_slice_frame(), 0.0, 1.0)
    assert img.shape == golden.shape == (108, 192, 3)
    tp.assert_distributional(img, golden)
    assert (np.abs(img - golden).max(axis=-1) > 5e-3).mean() <= 0.01


def test_slice_matches_jax_render():
    ref = np.asarray(sk.render(jax_sphere_repeat(), 192, 108,
                               camera_position=(-2.0, 2.0, 4.0), backend="jnp"))
    img = _slice_frame()
    assert np.isfinite(img).all()
    tp.assert_distributional(img, ref)


def test_raymarcher_entry_points_agree():
    s = scenes.sphere_repeat_scene()
    m = st.RayMarcher(24, 16, s, view=st.look_at((-2, 2, 4), (0, 0, 0), (0, 1, 0)))
    assert m.backend == "torch"
    with torch.no_grad():
        np.testing.assert_array_equal(
            m.render().numpy(), st.render(s, 24, 16, camera_position=(-2, 2, 4)).numpy())


PARITY_SCENES = ("repeat_xy_plain", "repeat_xy", "repeat_indexed")


@pytest.mark.parametrize("w,h", [(40, 24), (17, 13)])
@pytest.mark.parametrize("name", PARITY_SCENES)
def test_parity_with_jax_jnp_path(name, w, h):
    jexpr, texpr = tp.build(name)
    with torch.no_grad():
        tm = st.RayMarcher(w, h, texpr)
        td, ti = tm.render_depth().numpy(), tm.render().numpy()
    jm = sk.RayMarcher(w, h, jexpr, backend="jnp")
    tp.assert_depth_close(td, np.asarray(jm.render_depth()))
    tp.assert_rgb_close(ti, np.asarray(jm.render()))


@pytest.mark.parametrize("name", PARITY_SCENES)
def test_parity_with_jax_fused_kernel_interpret(name):
    jexpr, texpr = tp.build(name)
    with torch.no_grad():
        tm = st.RayMarcher(40, 24, texpr)
        td, ti = tm.render_depth().numpy(), tm.render().numpy()
        td_small = st.RayMarcher(17, 13, texpr).render_depth().numpy()
    jm = sk.RayMarcher(40, 24, jexpr, backend="fused")
    tp.assert_depth_close(td, np.asarray(jm.render_depth()))
    tp.assert_rgb_close(ti, np.asarray(jm.render()))
    tp.assert_depth_close(
        td_small, np.asarray(sk.RayMarcher(17, 13, jexpr, backend="fused").render_depth()))
