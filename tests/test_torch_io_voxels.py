"""TGA writers and the Voxels container of the port: the TGA and Voxels cases
of ``tests/test_io.py``, the bytes of every written file held against the JAX
package's writer on the same image, and ``.npz`` volumes crossing between the
two packages in both directions (exact: the archive holds float32 arrays)."""

import numpy as np
import pytest
import torch

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.io import tga as jax_tga
from sdfkit_tpu.mesh.mesh import Mesh as JaxMesh
from sdfkit_tpu_torch.io.tga import read_tga, write_depth_tga, write_tga

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")


class TestTga:
    def test_rgb_roundtrip(self, tmp_path):
        img = np.random.default_rng(0).uniform(0, 1, size=(12, 17, 3)).astype(np.float32)
        write_tga(tmp_path / "img.tga", img)
        back = read_tga(tmp_path / "img.tga")
        assert back.shape == (12, 17, 3)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)
        jax_tga.write_tga(tmp_path / "ref.tga", img)
        assert (tmp_path / "img.tga").read_bytes() == (tmp_path / "ref.tga").read_bytes()

    def test_rgb_clips_out_of_range(self, tmp_path):
        write_tga(tmp_path / "clip.tga", np.array([[[-0.5, 0.5, 1.5]]], np.float32))
        np.testing.assert_allclose(read_tga(tmp_path / "clip.tga")[0, 0], [0.0, 0.5, 1.0],
                                   atol=1 / 255)

    def test_depth_near_white_far_black(self, tmp_path):
        depth = np.array([[1.0, 50.0, 100.0, 1e6]], np.float32)
        write_depth_tga(tmp_path / "depth.tga", depth, near=1.0, far=100.0)
        gray = read_tga(tmp_path / "depth.tga")[0, :, 0]
        assert gray[0] == 1.0  # near plane -> white
        assert gray[0] > gray[1] > gray[2]  # monotone toward far
        assert gray[3] == 0.0  # misses past far -> black
        jax_tga.write_depth_tga(tmp_path / "ref.tga", depth, near=1.0, far=100.0)
        assert (tmp_path / "depth.tga").read_bytes() == (tmp_path / "ref.tga").read_bytes()

    def test_rendered_image_writes(self, tmp_path):
        with torch.no_grad():
            img = st.sphere(1.0).to_image(16, 8).numpy()
        write_tga(tmp_path / "render.tga", img)
        back = read_tga(tmp_path / "render.tga")
        assert back.shape == (8, 16, 3)
        # Sky pixels survive the round trip (the corner ray misses the sphere).
        np.testing.assert_allclose(back[0, 0], [0.5, 0.75, 1.0], atol=1 / 255)

    def test_read_rejects_other_formats(self, tmp_path):
        (tmp_path / "bad.tga").write_bytes(bytes([0, 0, 10] + [0] * 13 + [24, 0]))
        with pytest.raises(ValueError, match="24-bit"):
            read_tga(tmp_path / "bad.tga")


class TestTgaOrientation:
    def test_red_on_top_external_decoder(self, tmp_path):
        from PIL import Image

        img = np.zeros((20, 30, 3), np.float32)
        img[:10] = [1.0, 0.0, 0.0]
        img[10:] = [0.0, 1.0, 0.0]
        write_tga(tmp_path / "red_on_top.tga", img)
        decoded = np.asarray(Image.open(tmp_path / "red_on_top.tga").convert("RGB"))
        np.testing.assert_array_equal(decoded[0], [[255, 0, 0]] * 30)
        np.testing.assert_array_equal(decoded[-1], [[0, 255, 0]] * 30)

    def test_black_on_top_depth_external_decoder(self, tmp_path):
        from PIL import Image

        depth = np.zeros((20, 30), np.float32)
        depth[:10] = 1.0  # top half far -> black
        write_depth_tga(tmp_path / "black_on_top.tga", depth, near=0.0, far=1.0)
        decoded = np.asarray(Image.open(tmp_path / "black_on_top.tga").convert("RGB"))
        assert decoded[0].max() == 0
        assert decoded[-1].min() == 255


def volumes():
    jexpr, texpr = tp.build("smooth_union", perturb_seed=9)
    lo, hi = (-1, -1, -1), (1.5, 1, 1)
    with torch.no_grad():
        tvox = texpr.to_voxels(lo, hi, 8, 6, 7)
    return jexpr.to_voxels(lo, hi, 8, 6, 7), tvox


FIELDS = ("values", "colors", "vmin", "vmax")


class TestVoxelsPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        _, vox = volumes()
        vox.save(tmp_path / "vol.npz")
        back = st.Voxels.load(tmp_path / "vol.npz")
        for k in FIELDS:
            assert getattr(back, k).dtype == torch.float32 and getattr(back, k).device.type == "cpu"
            np.testing.assert_array_equal(getattr(back, k).numpy(), getattr(vox, k).numpy())
        assert back.values.shape == (8, 6, 7) and back.colors.shape == (8, 6, 7, 3)

    def test_a_volume_saved_by_the_port_loads_in_the_jax_package(self, tmp_path):
        jvox, tvox = volumes()
        tvox.save(tmp_path / "port.npz")
        back = sk.Voxels.load(tmp_path / "port.npz")
        for k in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(back, k)), getattr(tvox, k).numpy())
        np.testing.assert_allclose(np.asarray(back.values), np.asarray(jvox.values), atol=1e-6)
        assert len(back.to_mesh().vertices) == len(jvox.to_mesh().vertices) > 0

    def test_a_volume_saved_by_the_jax_package_loads_in_the_port(self, tmp_path):
        jvox, tvox = volumes()
        jvox.save(tmp_path / "jax.npz")
        back = st.Voxels.load(tmp_path / "jax.npz")
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(back, k).numpy(), np.asarray(getattr(jvox, k)))
        np.testing.assert_allclose(back.values.numpy(), tvox.values.numpy(), atol=1e-6)
        assert back.value_at((0.0, 0.0, 0.0)) == pytest.approx(jvox.value_at((0.0, 0.0, 0.0)))

    def test_volumes_cross_in_memory(self):
        jvox, tvox = volumes()
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(tp.voxels_to_torch(jvox), k).numpy(),
                                          np.asarray(getattr(jvox, k)))
            np.testing.assert_array_equal(np.asarray(getattr(tp.voxels_to_jax(tvox), k)),
                                          getattr(tvox, k).numpy())


def test_mesh_is_the_jax_packages_container():
    """The port's own copy of the numpy-only ``Mesh``: bounds, transform and
    OBJ text equal the JAX package's on the same triangle soup."""
    rng = np.random.default_rng(1)
    args = (rng.standard_normal((6, 3)), rng.uniform(0, 1, (6, 3)), rng.standard_normal((6, 3)),
            np.arange(6))
    a, b = st.Mesh(*args), JaxMesh(*args)
    assert a.to_obj_string() == b.to_obj_string()
    np.testing.assert_array_equal(a.center, b.center)
    assert a.radius == b.radius
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = [1.0, 2.0, 3.0]
    m[0, 0] = 2.0
    np.testing.assert_array_equal(a.transform(m).vertices, b.transform(m).vertices)
    np.testing.assert_array_equal(a.transform(m).normals, b.transform(m).normals)
    assert st.Mesh([], [], [], []).radius == 0.0
