"""Batched sampling and voxelization: the cases of ``tests/test_sample.py``
and ``tests/test_grid.py`` on the port, each also held against the JAX
package's result on the same inputs (numpy, seeded): ``sample`` and
``voxelize`` at atol 1e-6 (one scene evaluation; the two packages differ by
FMA contraction and ``x/C`` rewriting under ``jit``, an ulp of values of
order 1), cell centres at atol 1e-6."""

import numpy as np
import pytest
import torch

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.ops.grid import cell_centers as jax_cell_centers
from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.grid import cell_centers, clip_values_to_bounds
from sdfkit_tpu_torch.sdf.sample import DEFAULT_BATCH_SIZE

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")


def rng_points(n, seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, size=(n, 3)).astype(np.float32)


def np_sample(*args, **kwargs):
    with torch.no_grad():
        return st.sample(*args, **kwargs).numpy()


class TestSample:
    def test_matches_direct_call(self):
        s = st.sphere(0.7, color=(0.2, 0.4, 0.8))
        pts = rng_points(300)
        out = np_sample(s, pts, batch_size=70)
        with torch.no_grad():
            np.testing.assert_allclose(out, s(torch.from_numpy(pts)).numpy(), atol=1e-6)
        ref = sk.sample(sk.sphere(0.7, color=(0.2, 0.4, 0.8)), pts, batch_size=70)
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-6)

    def test_remainder_batch(self):
        # 300 points / 70 = 4 full batches + a 20-point remainder; the
        # remainder comes back exact, not padded.
        s = st.solid(lambda p: p.x)
        pts = rng_points(300, seed=1)
        out = np_sample(s, pts, batch_size=70)
        assert out.shape == (300, 4)
        np.testing.assert_allclose(out[:, 3], pts[:, 0], atol=1e-6)

    def test_batch_shape_seen_by_sdf(self):
        # Full batches of batch_size points, then the short remainder as it
        # is: eager torch keeps no static shape, so nothing is padded (the
        # JAX package pads the remainder because it traces one batch shape).
        seen = []

        def probe(p):
            seen.append(tuple(p.x.shape))
            return p.length() - 1.0

        np_sample(st.solid(probe), rng_points(300, seed=2), batch_size=70)
        assert seen == [(70,)] * 4 + [(20,)]

    def test_batch_larger_than_n(self):
        pts = rng_points(5, seed=3)
        out = np_sample(st.sphere(1.0), pts, batch_size=2048)
        np.testing.assert_allclose(out[:, 3], np.linalg.norm(pts, axis=1) - 1.0, atol=1e-5)

    def test_method_form(self):
        s = st.sphere(1.0)
        pts = rng_points(10, seed=4)
        with torch.no_grad():
            np.testing.assert_allclose(s.sample(pts).numpy(), np_sample(s, pts), atol=0)
            np.testing.assert_allclose(s.to_sdf()(torch.from_numpy(pts)).numpy(),
                                       np_sample(s, pts), atol=0)
        assert DEFAULT_BATCH_SIZE == 1 << 20

    def test_rejects_bad_shape(self):
        with pytest.raises(ValueError, match=r"\(N, 3\)"):
            st.sample(st.sphere(1.0), np.zeros((4, 2), np.float32))
        with pytest.raises(ValueError, match=r"\(N, 3\)"):
            st.sample(st.sphere(1.0), np.zeros((3,), np.float32))

    @pytest.mark.parametrize("name", ["sphere_repeat", "smooth_union", "repeat_indexed"])
    def test_matches_the_jax_package(self, name):
        jexpr, texpr = tp.build(name, perturb_seed=2)
        pts = rng_points(1000, seed=5)
        np.testing.assert_allclose(np_sample(texpr, pts, batch_size=333),
                                   np.asarray(sk.sample(jexpr, pts, batch_size=333)), atol=1e-6)

    def test_points_on_another_device_than_the_scene_raise(self):
        with pytest.raises(ValueError, match="the scene is on"):
            st.sample(st.sphere(1.0), torch.zeros((4, 3), device="meta"))
        out = st.sample(st.sphere(1.0), torch.zeros((0, 3)))
        assert out.shape == (0, 4)

    def test_is_differentiable(self):
        s = st.sphere(1.0)
        st.sample(s, rng_points(50, seed=6), batch_size=16)[:, 3].sum().backward()
        np.testing.assert_allclose(float(s.radius.grad), -50.0, rtol=1e-6)


class TestSdfTestsGoldens:
    def test_volume_sphere_128(self):
        # 128^3 over [-1,1]^3, v[63,63,63] == -0.5 +- 2e-2.
        r = 0.5
        with torch.no_grad():
            v = st.voxelize(st.sphere(r), (-1, -1, -1), (1, 1, 1), 128, 128, 128)
        assert abs(float(v.values[63, 63, 63]) + r) < 2e-2

    def test_to_mesh_waits_for_marching_cubes(self):
        # Marching cubes has landed: both entry points mesh, and agree with
        # the JAX package (SdfTests.cs CreateMeshSphere: 1248 vertices at 32^3).
        m = st.sphere(0.5).to_mesh((-1, -1, -1), (1, 1, 1), 32, 32, 32)
        jm = sk.sphere(0.5).to_mesh((-1, -1, -1), (1, 1, 1), 32, 32, 32)
        assert len(m.vertices) == len(jm.vertices) == 1248
        np.testing.assert_array_equal(m.triangles, jm.triangles)
        with torch.no_grad():
            v = st.sphere(0.5).to_voxels((-1, -1, -1), (1, 1, 1), 4, 4, 4)
        assert len(v.to_mesh().vertices) == len(
            sk.sphere(0.5).to_voxels((-1, -1, -1), (1, 1, 1), 4, 4, 4).to_mesh().vertices)


class TestCellCenters:
    def test_single_cell_is_center(self):
        p = cell_centers((-1, -1, -1), (1, 1, 1), 1, 1, 1)
        np.testing.assert_allclose(
            [float(p.x[0, 0, 0]), float(p.y[0, 0, 0]), float(p.z[0, 0, 0])], [0.0, 0.0, 0.0],
            atol=1e-6)

    def test_3cube_contains_origin(self):
        p = cell_centers((-1, -1, -1), (1, 1, 1), 3, 3, 3)
        np.testing.assert_allclose(
            [float(p.x[1, 1, 1]), float(p.y[1, 1, 1]), float(p.z[1, 1, 1])], [0.0, 0.0, 0.0],
            atol=1e-6)

    def test_positions_encode(self):
        probe = st.solid(lambda p: p.x + 10.0 * p.y + 100.0 * p.z)
        v = st.voxelize(probe, (0, 0, 0), (2, 2, 2), 2, 2, 2, clip_to_bounds=False)
        np.testing.assert_allclose(float(v.values[0, 0, 0]), 0.5 + 5.0 + 50.0, atol=1e-5)
        np.testing.assert_allclose(float(v.values[1, 0, 1]), 1.5 + 5.0 + 150.0, atol=1e-4)

    def test_matches_the_jax_package(self):
        lo, hi = (-1.5, -0.5, 0.25), (2.0, 1.0, 3.0)
        p = cell_centers(lo, hi, 5, 7, 3)
        ref = jax_cell_centers(lo, hi, 5, 7, 3)
        for a, b in zip((p.x, p.y, p.z), (ref.x, ref.y, ref.z)):
            assert tuple(a.shape) == (5, 7, 3)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        with pytest.raises(ValueError, match="3 components"):
            cell_centers((0, 0), (1, 1), 2, 2, 2)


class TestVoxelize:
    def test_dims_and_world_size(self):
        v = st.voxelize(st.sphere(1.0), (-2, -2, -2), (2, 2, 2), 4, 6, 8)
        assert v.values.shape == (4, 6, 8)
        assert v.colors.shape == (4, 6, 8, 3)
        assert (v.nx, v.ny, v.nz) == (4, 6, 8)
        np.testing.assert_allclose(v.size.numpy(), [4, 4, 4])
        np.testing.assert_allclose(v.center.numpy(), [0, 0, 0])
        np.testing.assert_allclose(v.d.numpy(), [1.0, 4 / 6, 0.5], rtol=1e-6)
        np.testing.assert_allclose(v.radius, np.sqrt(48.0) / 2, rtol=1e-6)

    def test_center_value_sphere(self):
        v = st.voxelize(st.sphere(1.0), (-1.5, -1.5, -1.5), (1.5, 1.5, 1.5), 5, 5, 5,
                        clip_to_bounds=False)
        np.testing.assert_allclose(float(v.values[2, 2, 2].detach()), -1.0, atol=1e-6)

    def test_colors_sampled(self):
        v = st.voxelize(st.sphere(1.0, color=(0.3, 0.6, 0.9)), (-1, -1, -1), (1, 1, 1), 3, 3, 3)
        np.testing.assert_allclose(v.colors[1, 1, 1].detach().numpy(), [0.3, 0.6, 0.9], atol=1e-6)

    def test_clip_to_bounds_walls(self):
        n = 5
        with torch.no_grad():
            v = st.voxelize(st.sphere(10.0), (-1, -1, -1), (1, 1, 1), n, n, n)
        outside = 2.0 / n
        vals = v.values.numpy()
        for wall in (vals[0], vals[-1], vals[:, 0], vals[:, -1], vals[:, :, 0], vals[:, :, -1]):
            np.testing.assert_allclose(wall, outside)
        assert vals[2, 2, 2] < 0  # interior untouched

    def test_unclipped_keeps_walls(self):
        with torch.no_grad():
            v = st.voxelize(st.sphere(10.0), (-1, -1, -1), (1, 1, 1), 5, 5, 5,
                            clip_to_bounds=False)
            assert float(v.values.max()) < 0
            clipped = v.clip_to_bounds()
        assert float(v.values.max()) < 0  # a copy: the volume itself is untouched
        np.testing.assert_allclose(clipped.values[0].numpy(), 0.4)
        np.testing.assert_array_equal(
            clipped.values.numpy(),
            clip_values_to_bounds(v.values, (-1, -1, -1), (1, 1, 1)).numpy())

    def test_world_space_indexer(self):
        v = st.voxelize(st.solid(lambda p: p.x), (-1, -1, -1), (1, 1, 1), 4, 4, 4,
                        clip_to_bounds=False)
        # p=(0.3,0,0) falls in cell ix=2 whose center x is 0.25.
        np.testing.assert_allclose(v.value_at((0.3, 0.0, 0.0)), 0.25, atol=1e-6)

    @pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
    @pytest.mark.parametrize("name", ["sphere_repeat", "smooth_union"])
    def test_matches_the_jax_package(self, name, clip):
        jexpr, texpr = tp.build(name, perturb_seed=4)
        lo, hi = (-1.5, -1.0, -1.25), (1.5, 2.0, 1.0)
        with torch.no_grad():
            v = texpr.to_voxels(lo, hi, 12, 9, 16, clip_to_bounds=clip)
        ref = sk.voxelize(jexpr, lo, hi, 12, 9, 16, clip_to_bounds=clip)
        np.testing.assert_allclose(v.values.numpy(), np.asarray(ref.values), atol=1e-6)
        np.testing.assert_allclose(v.colors.numpy(), np.asarray(ref.colors), atol=1e-6)
        np.testing.assert_array_equal(v.vmin.numpy(), np.asarray(ref.vmin))
        np.testing.assert_array_equal(v.vmax.numpy(), np.asarray(ref.vmax))

    def test_callbacks_see_grid_shaped_components(self):
        seen = []

        def probe(p):
            seen.append(tuple(p.x.shape))
            return ops.abs(p.x) - 0.5

        st.voxelize(st.solid(probe), (-1, -1, -1), (1, 1, 1), 2, 3, 4)
        assert seen == [(2, 3, 4)]
