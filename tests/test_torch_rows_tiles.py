"""Row bands and resumable tiles.

``render_rows_kernel`` renders ``n_rows`` rows of a larger image from a flat
pixel offset, through the image kernels; the g++ build of their per-pixel code
stands in for the launches here (``torch_host``). It is held against the JAX
package's ``render_rows_fused`` (the Pallas kernel in interpret mode): values
by ``torch_parity``'s contracts between two programs, gradients of the
leaves, ``ivp`` and ``cam`` by the bounds of ``test_torch_kernel_bwd_host.py``
(``ivp`` and ``cam`` together are that file's "view": rtol 5e-2 plus 2e-2 of
the largest entry). Against the port's own whole-frame render a band is equal
bit for bit (the same per-pixel code at the same pixel index), and the bands'
gradients add up to the frame's to 1e-6 of the largest entry (each launch's
float64 host sum is rounded to float32 once).

``render_tiles_resumable`` is held to the one-device cases of
``tests/test_elastic.py`` on both backends: a run resumed after a crash is
bit-identical to an uninterrupted one, a directory of another job is
refused, ``progress`` is called after every tile.
"""

import json
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
from sdfkit_tpu_torch.parallel import render_tiles_resumable
from sdfkit_tpu_torch.parallel.distributed import single
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig, resolve_backend
from sdfkit_tpu_torch.utils.camera import inv_view_proj
from test_torch_kernel_bwd_host import assert_grads_close
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

VIEW = ((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
W, H = 24, 16
BAND = (5, 7)  # first row, rows


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("rows_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    return patch_kernels(monkeypatch, host_libs)


def view_scalars(cfg, requires_grad=False, view=VIEW):
    with torch.no_grad():
        ivp, cam = inv_view_proj(st.look_at(*view), cfg.width, cfg.height, cfg.vfov_degrees,
                                 cfg.near, cfg.far)
    return (ivp.clone().requires_grad_(requires_grad), cam.clone().requires_grad_(requires_grad))


def jax_rows(jexpr, ivp, cam, r0, n_rows, want_color, width=W, height=H):
    jcfg = jrm.RenderConfig(width=width, height=height)
    fn = jrk.render_rows_fused if want_color else jrk.render_depth_rows_fused
    return fn(jexpr, ivp, cam, jnp.int32(r0 * width), jcfg, n_rows)


FRONT = ((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


@pytest.mark.parametrize("name,view,w,h", [("union", VIEW, W, H), ("repeat_xy", FRONT, 40, 24),
                                           ("repeat_indexed", FRONT, 40, 24)])
def test_a_band_matches_the_pallas_rows_and_the_whole_frame(host_kernels, name, view, w, h):
    jexpr, texpr = tp.build(name)
    cfg = RenderConfig(w, h)
    ivp, cam = view_scalars(cfg, view=view)
    r0, n = BAND
    with torch.no_grad():
        rgb = rk.render_rows_kernel(texpr, ivp, cam, r0 * w, cfg, n)
        depth = rk.render_depth_rows_kernel(texpr, ivp, cam, torch.tensor(r0 * w), cfg, n)
        frame = rk.render_image_kernel(texpr, st.look_at(*view), cfg)
        frame_depth = rk.render_depth_image_kernel(texpr, st.look_at(*view), cfg)
    assert rgb.shape == (n, w, 3) and depth.shape == (n, w)
    np.testing.assert_array_equal(rgb.numpy(), frame[r0:r0 + n].numpy())
    np.testing.assert_array_equal(depth.numpy(), frame_depth[r0:r0 + n].numpy())
    jivp, jcam = jnp.asarray(ivp.numpy()).reshape(1, 16), jnp.asarray(cam.numpy()).reshape(1, 3)
    tp.assert_rgb_close(rgb.numpy(), np.asarray(jax_rows(jexpr, jivp, jcam, r0, n, True, w, h)))
    tp.assert_depth_close(depth.numpy(),
                          np.asarray(jax_rows(jexpr, jivp, jcam, r0, n, False, w, h)))


def t_loss(img, want_color):
    if want_color:
        return (img ** 2).sum()
    return (torch.where(img < 50.0, img, torch.zeros_like(img)) ** 2).sum()


def port_row_grads(texpr, cfg, bands, want_color):
    """(leaf gradients, the 19 gradients of ivp then cam) of the loss summed
    over ``bands`` of (first row, rows)."""
    for p in st.leaves(texpr):
        p.grad = None
    ivp, cam = view_scalars(cfg, requires_grad=True)
    fn = rk.render_rows_kernel if want_color else rk.render_depth_rows_kernel
    sum(t_loss(fn(texpr, ivp, cam, r0 * cfg.width, cfg, n), want_color)
        for r0, n in bands).backward()
    return tp.leaf_grads(texpr), np.concatenate([ivp.grad.numpy().reshape(-1),
                                                 cam.grad.numpy().reshape(-1)])


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_band_gradients_match_jax_rows(host_kernels, want_color):
    jexpr, texpr = tp.build("union")
    cfg = RenderConfig(W, H)
    got = port_row_grads(texpr, cfg, [BAND], want_color)
    assert (host_kernels["fwd"], host_kernels["bwd"]) == (1, 1)
    ivp, cam = view_scalars(cfg)

    def loss(s, i, c):
        img = jax_rows(s, i, c, *BAND, want_color)
        return jnp.sum(img ** 2) if want_color else jnp.sum(jnp.where(img < 50.0, img, 0.0) ** 2)

    gs, gi, gc = jax.grad(loss, argnums=(0, 1, 2))(
        jexpr, jnp.asarray(ivp.numpy()).reshape(1, 16), jnp.asarray(cam.numpy()).reshape(1, 3))
    ref = (tp.jax_leaf_grads(gs), np.concatenate([np.asarray(gi).reshape(-1),
                                                  np.asarray(gc).reshape(-1)]))
    assert_grads_close(got, ref)


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_band_gradients_add_up_to_the_frame(host_kernels, want_color):
    _, texpr = tp.build("sphere_repeat")
    cfg = RenderConfig(W, H)
    whole = port_row_grads(texpr, cfg, [(0, H)], want_color)
    bands = port_row_grads(texpr, cfg, [(0, 5), (5, H - 5)], want_color)
    for a, b in zip((*whole[0], whole[1]), (*bands[0], bands[1])):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * max(float(np.abs(a).max()), 1e-30))


def test_a_band_outside_the_image_raises(host_kernels):
    _, texpr = tp.build("union")
    cfg = RenderConfig(W, H)
    ivp, cam = view_scalars(cfg)
    with pytest.raises(ValueError, match="pixel range"):
        rk.render_rows_kernel(texpr, ivp, cam, (H - 2) * W, cfg, 3)
    assert host_kernels["fwd"] == 0


def test_rows_raise_on_cpu_tensors():
    _, texpr = tp.build("union")
    cfg = RenderConfig(W, H)
    launches = rk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_rows_kernel(texpr, *view_scalars(cfg), 0, cfg, 4)
    assert rk.LAUNCHES == launches


# -- resumable tiles ------------------------------------------------------------

def scene():
    return st.sphere(1.0, color=(0.8, 0.4, 0.2)) | st.box(0.5).translate(1.2, 0, 0)


@pytest.fixture(params=["torch", "kernel"])
def tile_backend(request):
    """'kernel' runs with the host build in place of the launches, on CPU
    tensors; ``resolve_backend`` is told so."""
    if request.param == "kernel":
        import sdfkit_tpu_torch.parallel.elastic as elastic

        monkeypatch = request.getfixturevalue("monkeypatch")
        request.getfixturevalue("host_kernels")
        monkeypatch.setattr(elastic, "resolve_backend", lambda backend, sdf: backend)
    return request.param


def test_resume_bit_identical(tile_backend, tmp_path):
    full, stats = render_tiles_resumable(scene(), 64, 48, tmp_path / "full", tile_rows=16,
                                         backend=tile_backend)
    assert stats == {"resumed": 0, "rendered": 3, "tiles": 3}
    assert full.shape == (48, 64, 3) and full.dtype == np.float32

    class Boom(Exception):
        pass

    seen = []

    def crash_after_2(done, total):
        seen.append((done, total))
        if done == 2:
            raise Boom()

    crash_dir = tmp_path / "crash"
    with pytest.raises(Boom):
        render_tiles_resumable(scene(), 64, 48, crash_dir, tile_rows=16, progress=crash_after_2,
                               backend=tile_backend)
    assert seen == [(1, 3), (2, 3)]
    (crash_dir / "tile_00002.npy.tmp.npy").write_bytes(b"half a tile")  # the crash's orphan
    img, stats = render_tiles_resumable(scene(), 64, 48, crash_dir, tile_rows=16,
                                        backend=tile_backend)
    assert stats == {"resumed": 2, "rendered": 1, "tiles": 3}
    np.testing.assert_array_equal(img, full)
    assert not list(crash_dir.glob("*.tmp.npy"))
    assert json.loads((crash_dir / "manifest.json").read_text())["backend"] == tile_backend
    # The tiles are the whole-frame render of the same backend, bit for bit
    # (and a ragged last tile changes nothing).
    with torch.no_grad():
        whole = st.RayMarcher(64, 48, scene(), backend="torch").render().numpy() \
            if tile_backend == "torch" else \
            rk.render_image_kernel(scene(), st.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)),
                                   RenderConfig(64, 48)).numpy()
    np.testing.assert_array_equal(full, whole)
    ragged, stats = render_tiles_resumable(scene(), 64, 48, tmp_path / "ragged", tile_rows=20,
                                           backend=tile_backend)
    assert stats["tiles"] == 3
    np.testing.assert_array_equal(ragged, full)


def test_manifest_mismatch_rejected(tile_backend, tmp_path):
    d = tmp_path / "job"
    render_tiles_resumable(scene(), 32, 16, d, tile_rows=8, backend=tile_backend)
    with pytest.raises(ValueError, match="manifest mismatch"):
        render_tiles_resumable(scene(), 32, 32, d, tile_rows=8, backend=tile_backend)
    edited = scene()
    with torch.no_grad():
        edited.a.radius.fill_(1.01)
    with pytest.raises(ValueError, match="manifest mismatch"):
        render_tiles_resumable(edited, 32, 16, d, tile_rows=8, backend=tile_backend)
    with pytest.raises(ValueError, match="manifest mismatch"):
        render_tiles_resumable(scene(), 32, 16, d, tile_rows=8, backend=tile_backend,
                               depth_iterations=30)
    other = "kernel" if tile_backend == "torch" else "torch"
    if other == "torch":  # a resume on the other backend is another job
        with pytest.raises(ValueError, match="manifest mismatch"):
            render_tiles_resumable(scene(), 32, 16, d, tile_rows=8, backend=other)


def test_tiles_match_the_jax_package(tmp_path):
    """The same job in both packages on their plain paths: two programs, the
    small-frame RGB contract."""
    import sdfkit_tpu as sk
    from sdfkit_tpu.parallel.elastic import render_tiles_resumable as jax_tiles

    jscene = sk.sphere(1.0, color=(0.8, 0.4, 0.2)) | sk.box(0.5).translate(1.2, 0, 0)
    ref, _ = jax_tiles(jscene, 40, 24, tmp_path / "jax", tile_rows=10, backend="jnp")
    img, _ = render_tiles_resumable(scene(), 40, 24, tmp_path / "torch", tile_rows=10)
    tp.assert_rgb_close(img, ref)
    # The two packages fingerprint a scene differently: tiles do not cross.
    with pytest.raises(ValueError, match="manifest mismatch"):
        render_tiles_resumable(scene(), 40, 24, tmp_path / "jax", tile_rows=10)


def test_mesh_is_refused_until_the_multi_device_path(tile_backend, tmp_path):
    """An object that is not a ``parallel.Mesh`` is refused before the
    directory is made. A mesh splits each tile's rows over its ranks: on a
    mesh of one the tiles are the frame's bit for bit, and a frame started
    on the mesh resumes without one (the mesh is not in the manifest).
    ``tests/test_torch_distributed.py`` runs 2 and 4 ranks."""
    with pytest.raises(TypeError, match="Mesh"):
        render_tiles_resumable(scene(), 16, 8, tmp_path / "m", mesh=object())
    assert not (tmp_path / "m").exists()
    one = single("cpu")
    img, stats = render_tiles_resumable(scene(), 16, 8, tmp_path / "one", tile_rows=3, mesh=one,
                                        backend=tile_backend)
    ref, _ = render_tiles_resumable(scene(), 16, 8, tmp_path / "ref", tile_rows=3,
                                    backend=tile_backend)
    assert stats == {"resumed": 0, "rendered": 3, "tiles": 3}
    np.testing.assert_array_equal(img, ref)
    (tmp_path / "one" / "tile_00001.npy").unlink()
    again, stats = render_tiles_resumable(scene(), 16, 8, tmp_path / "one", tile_rows=3,
                                          backend=tile_backend)
    assert stats == {"resumed": 2, "rendered": 1, "tiles": 3}
    np.testing.assert_array_equal(again, ref)


def test_resolve_backend_is_the_one_rule():
    s = scene()
    assert resolve_backend("auto", s) == "torch" and resolve_backend("torch", s) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        resolve_backend("kernel", s)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("fused", s)
    with pytest.raises(ValueError, match="CUDA"):
        render_tiles_resumable(s, 16, 8, "unused", backend="kernel")
    with st.use_device("meta"):
        assert st.RayMarcher(8, 4, st.sphere(1.0), backend="torch").backend == "torch"
