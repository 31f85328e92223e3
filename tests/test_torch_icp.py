"""Registration on the port (``sdfkit_tpu_torch/registration/icp.py``): every
case of ``tests/test_icp.py``, and the port's ``nearest_neighbors``, ``GridNN``
and both registration loops held to the JAX package's functions on the same
seeded clouds at that file's tolerances.

Brute-force indices are held to the JAX package's only where the query's two
nearest points are more than 1e-5 (|q|^2 + |p|^2) apart in squared distance
(p the nearest point; the expansion q^2 - 2 q.p + p^2 rounds relative to
those magnitudes): the two packages' matrix products sum ``q.p`` in different
orders, so a near-tie may rank differently. Such queries are counted, not
compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu.registration import icp as jicp
from sdfkit_tpu_torch.registration import icp
from sdfkit_tpu_torch.registration.icp import (
    GridNN,
    IterativeClosestPoint,
    NearestNeighbors,
    global_register_points,
    nearest_neighbors,
    register_points_torch,
    robust_distance_cutoff,
)

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

THREE_POINTS = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float32)


def rot_x(rad):
    """System.Numerics CreateRotationX, row-vector convention."""
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, s, -s, c
    return m


def rot_y(rad):
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def translation(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = [x, y, z]
    return m


def apply(points, m):
    return points @ m[:3, :3] + m[3, :3]


def np_nn(points, queries, **kw):
    idx, dist = nearest_neighbors(torch.from_numpy(points), queries, **kw)
    return idx.numpy(), dist.numpy()


def near_ties(points, queries):
    """Queries whose two nearest points are within the tie margin, from
    float64 squared distances."""
    q = queries.astype(np.float64)
    d2 = ((q[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)[:, :2]
    two = np.take_along_axis(d2, order, axis=1)
    scale = (q ** 2).sum(1) + (points[order[:, 0]].astype(np.float64) ** 2).sum(1)
    return (two[:, 1] - two[:, 0]) <= 1e-5 * scale


def assert_indices_match_jax(idx, jidx, points, queries):
    ties = near_ties(points, queries)
    np.testing.assert_array_equal(idx[~ties], np.asarray(jidx)[~ties])
    return int(ties.sum()), int((idx[ties] != np.asarray(jidx)[ties]).sum())


class TestNearestNeighbors:
    def test_three_points(self):
        nn = NearestNeighbors(THREE_POINTS)
        assert nn.total_points == 3
        nearest, dist = nn.search(np.array([0.0, 1.5, 0.0]))
        np.testing.assert_array_equal(nearest, [0, 1, 0])
        assert abs(dist - 0.5) < 1e-4

    def test_random_points(self):
        rng = np.random.default_rng(0)
        pts = (1000.0 * (rng.random((10_000, 3)) * 2 - 1)).astype(np.float32)
        nn = NearestNeighbors(pts)
        offset = np.array([0.01, 0.01, 0.01], np.float32)
        nearest, dist = nn.search(pts[1234] + offset)
        np.testing.assert_array_equal(nearest, pts[1234])
        assert abs(dist - np.linalg.norm(offset)) < 1e-4

    def test_batch_search_matches_loop(self):
        rng = np.random.default_rng(1)
        pts = rng.random((500, 3)).astype(np.float32)
        qs = rng.random((40, 3)).astype(np.float32)
        idx, _ = np_nn(pts, qs)
        np.testing.assert_array_equal(idx, ((qs[:, None, :] - pts[None]) ** 2).sum(-1).argmin(1))

    def test_chunking_consistent(self):
        rng = np.random.default_rng(2)
        pts = rng.random((5000, 3)).astype(np.float32)
        qs = rng.random((64, 3)).astype(np.float32)
        i1, d1 = np_nn(pts, qs, chunk=256)
        i2, d2 = np_nn(pts, qs, chunk=5000)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, atol=1e-5)

    def test_add_points(self):
        nn = NearestNeighbors(THREE_POINTS)
        nn.add_points([[5.0, 5.0, 5.0]])
        nearest, _ = nn.search(np.array([4.9, 5.0, 5.0]))
        np.testing.assert_array_equal(nearest, [5, 5, 5])

    def test_ties_go_to_the_lowest_index(self):
        pts = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0], [-1, 0, 0]], np.float32)
        idx, _ = np_nn(pts, np.zeros((1, 3), np.float32), chunk=1)
        assert idx.tolist() == [0]

    def test_the_callers_matmul_precision_comes_back(self):
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            np_nn(THREE_POINTS, THREE_POINTS)
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.set_float32_matmul_precision(before)

    @pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1000.0), (2, 0.01)])
    def test_against_the_jax_package(self, seed, scale):
        rng = np.random.default_rng(seed)
        pts = (scale * rng.uniform(-1, 1, (4000, 3))).astype(np.float32)
        qs = (scale * rng.uniform(-1.1, 1.1, (700, 3))).astype(np.float32)
        idx, dist = np_nn(pts, qs, chunk=512)
        jidx, jdist = jicp.nearest_neighbors(pts, qs, chunk=512)
        n_ties, n_apart = assert_indices_match_jax(idx, jidx, pts, qs)
        assert n_ties < 10 and n_apart <= n_ties
        same = idx == np.asarray(jidx)
        np.testing.assert_allclose(dist[same], np.asarray(jdist)[same], rtol=2e-7)


def _points_test(points, expected, keep=1.0, seed=0):
    rng = np.random.default_rng(seed)
    sources = points[rng.random(len(points)) < keep]
    transformed = apply(sources, expected)
    aligned, inv_transform = IterativeClosestPoint(points).register_points(transformed)
    recovered = np.linalg.inv(inv_transform)
    np.testing.assert_allclose(recovered[3, :3], expected[3, :3], atol=1e-4)
    for i in range(3):
        assert abs(recovered[i, i] - expected[i, i]) < 1e-6
    np.testing.assert_allclose(aligned, sources, atol=1e-4)
    np.testing.assert_allclose(apply(transformed, inv_transform), sources, atol=1e-4)
    return transformed, aligned, inv_transform


def _composed():
    return translation(0, 0, 0.1) @ rot_x(np.deg2rad(1.0)) @ translation(0, 0.1, 0)


ICP_CASES = {
    "three_points_offset_x": (THREE_POINTS, translation(0.1, 0, 0), 1.0),
    "three_points_offset_xyz": (THREE_POINTS, translation(0.1, -0.2, -0.3), 1.0),
    "three_points_rotate_y": (THREE_POINTS, rot_y(np.deg2rad(1.0)), 1.0),
    "three_points_rotate_x_offset_y": (THREE_POINTS,
                                       rot_x(np.deg2rad(1.0)) @ translation(0, 0.1, 0), 1.0),
    "three_points_composed": (THREE_POINTS, _composed(), 1.0),
    "random_points_half_kept": (
        (np.random.default_rng(0).random((100, 3)) - 0.5).astype(np.float32), _composed(), 0.5),
}


class TestIcp:
    @pytest.mark.parametrize("name", ICP_CASES)
    def test_case(self, name):
        points, expected, keep = ICP_CASES[name]
        transformed, aligned, inv = _points_test(points, expected, keep)
        # The JAX package's host loop lands on the same transform.
        j_aligned, j_inv = jicp.IterativeClosestPoint(points).register_points(transformed,
                                                                              parity=True)
        np.testing.assert_allclose(inv, j_inv, atol=1e-6)
        np.testing.assert_allclose(aligned, j_aligned, atol=1e-6)

    def test_global_register(self):
        rng = np.random.default_rng(3)
        base = (rng.random((200, 3)) - 0.5).astype(np.float32)
        scans = [base, apply(base, translation(0.05, 0, 0)), apply(base, translation(0, 0.05, 0))]
        aligned, tfs = global_register_points(scans)
        assert len(aligned) == 3
        np.testing.assert_array_equal(tfs[0], np.eye(4))
        np.testing.assert_allclose(aligned[1], base, atol=1e-3)
        np.testing.assert_allclose(aligned[2], base, atol=1e-3)
        j_aligned, j_tfs = jicp.global_register_points(scans)
        for a, b in zip(tfs, j_tfs):
            np.testing.assert_allclose(a, b, atol=1e-5)

    def test_global_register_empty_and_single(self):
        assert global_register_points([]) == ([], [])
        a, t = global_register_points([THREE_POINTS])
        assert len(a) == 1 and len(t) == 1

    def test_static_points_from_a_list_and_a_tensor(self):
        a = IterativeClosestPoint([THREE_POINTS[:2], THREE_POINTS[2:]])
        b = IterativeClosestPoint(torch.from_numpy(THREE_POINTS))
        assert a._nn.total_points == b._nn.total_points == 3
        with pytest.raises(ValueError):
            IterativeClosestPoint([])


class TestTorchIcp:
    """The device loop (register_points_torch): parity with the host loop and
    with the JAX package's scan, and gradients."""

    def _fixture(self, seed=4, n=80):
        rng = np.random.default_rng(seed)
        pts = (rng.random((n, 3)) - 0.5).astype(np.float32)
        return pts, apply(pts, translation(0.05, -0.02, 0.03) @ rot_y(np.deg2rad(1.0)))

    def test_parity_with_the_host_loop(self):
        pts, transformed = self._fixture()
        aligned_np, inv_np = IterativeClosestPoint(pts).register_points(transformed)
        aligned_t, inv_t = register_points_torch(pts, transformed)
        np.testing.assert_allclose(aligned_t.numpy(), aligned_np, atol=1e-4)
        np.testing.assert_allclose(inv_t.numpy(), inv_np, atol=1e-4)
        np.testing.assert_allclose(aligned_t.numpy(), pts, atol=1e-3)

    def test_against_the_jax_scan(self):
        pts, transformed = self._fixture()
        aligned_t, inv_t = register_points_torch(pts, transformed)
        aligned_j, inv_j = jicp.register_points_jax(pts, transformed)
        np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), atol=1e-4)
        np.testing.assert_allclose(aligned_t.numpy(), np.asarray(aligned_j), atol=1e-4)

    def test_gradient_through_alignment(self):
        rng = np.random.default_rng(5)
        pts = (rng.random((50, 3)) - 0.5).astype(np.float32)
        target = torch.from_numpy(pts)

        def loss(theta):
            c, s = torch.cos(theta), torch.sin(theta)
            zero, one = torch.zeros(()), torch.ones(())
            r = torch.stack([torch.stack([c, zero, -s]), torch.stack([zero, one, zero]),
                             torch.stack([s, zero, c])])
            scan = target @ r + torch.tensor([0.05, 0.0, 0.0])
            aligned, _ = register_points_torch(target, scan, max_iterations=10)
            return torch.mean((aligned - target) ** 2)

        theta = torch.tensor(0.02, requires_grad=True)
        loss(theta).backward()
        g = float(theta.grad)
        assert np.isfinite(g)
        eps = 1e-3
        with torch.no_grad():
            fd = (float(loss(torch.tensor(0.02 + eps))) - float(loss(torch.tensor(0.02 - eps)))) \
                / (2 * eps)
        assert abs(g - fd) < max(0.2 * abs(fd), 1e-4)

        def jax_loss(theta):
            c, s = jnp.cos(theta), jnp.sin(theta)
            r = jnp.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
            scan = pts @ r + jnp.array([0.05, 0.0, 0.0])
            aligned, _ = jicp.register_points_jax(pts, scan, max_iterations=10)
            return jnp.mean((aligned - pts) ** 2)

        jg = float(jax.grad(jax_loss)(jnp.float32(0.02)))
        assert abs(g - jg) < max(0.2 * abs(jg), 1e-4)

    def test_gradient_reaches_both_point_sets(self):
        static, moved = self._fixture(seed=8, n=60)
        s = torch.from_numpy(static).requires_grad_()
        m = torch.from_numpy(moved).requires_grad_()
        aligned, total = register_points_torch(s, m, max_iterations=5)
        (aligned.square().sum() + total.sum()).backward()
        assert bool(torch.isfinite(s.grad).all()) and bool(torch.isfinite(m.grad).all())
        assert float(s.grad.abs().sum()) > 0 and float(m.grad.abs().sum()) > 0

    def test_unknown_nn_mode(self):
        with pytest.raises(ValueError, match="unknown nn mode"):
            register_points_torch(THREE_POINTS, THREE_POINTS, nn="kd")


class TestOutlierRejection:
    def test_far_outliers_rejected(self):
        rng = np.random.default_rng(6)
        pts = (rng.random((200, 3)) - 0.5).astype(np.float32)
        m = translation(0.08, 0.0, -0.05)
        outliers = np.array([[10.0, 10.0, 10.0], [-10, 8, 9], [9, -10, 8], [8, 9, -10],
                             [10, 0, -10]], np.float32)
        scan = np.concatenate([apply(pts, m).astype(np.float32), outliers])
        aligned, inv_transform = IterativeClosestPoint(pts).register_points(scan)
        np.testing.assert_allclose(np.linalg.inv(inv_transform)[3, :3], m[3, :3], atol=5e-3)
        np.testing.assert_allclose(aligned[:200], pts, atol=5e-3)
        aligned_t, _ = register_points_torch(pts, scan)
        np.testing.assert_allclose(aligned_t.numpy(), aligned, atol=1e-4)


class TestOutlierBranches:
    def test_all_four_branches(self):
        good = 0.01
        assert robust_distance_cutoff(0.005, 0.1, good) == 0.005 + 3 * 0.1
        assert robust_distance_cutoff(0.02, 0.1, good) == 0.02 + 2 * 0.1
        assert robust_distance_cutoff(0.05, 0.1, good) == 0.05 + 0.1
        assert robust_distance_cutoff(0.5, 0.1, good) == 0.5 + 0.5 + 0.1

    def test_bimodal_far_cluster_branch4(self):
        dist = np.concatenate([np.full(75, 0.2), np.full(25, 2.0)])
        cutoff = robust_distance_cutoff(float(dist.mean()), float(dist.std()))
        assert dist.mean() > 6 * 0.01
        assert (dist[:75] <= cutoff).all() and (dist[75:] > cutoff).all()
        dist2 = np.concatenate([np.full(80, 0.1), np.full(20, 0.8)])
        cutoff2 = robust_distance_cutoff(float(dist2.mean()), float(dist2.std()))
        assert dist2.mean() > 6 * 0.01
        assert (dist2 <= cutoff2).all()  # the reference keeps both modes here


class TestLoopChoice:
    """register_points: the host loop when the static points are on the CPU,
    the device loop otherwise, whatever the settings; both loops read
    ``max_iterations`` and the thresholds at run time."""

    def test_device_loop_matches_parity(self):
        rng = np.random.default_rng(3)
        static = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        moved = apply(static, translation(0.02, -0.01, 0.015))
        icp_ = IterativeClosestPoint(static)
        a_par, tf_par = icp_.register_points(moved, parity=True)
        a_dev, tf_dev = icp_.register_points(moved, parity=False)
        assert a_dev.dtype == tf_dev.dtype == np.float32
        np.testing.assert_allclose(a_dev, a_par, atol=1e-4)
        np.testing.assert_allclose(tf_dev, tf_par, atol=1e-4)

    def _spy(self, icp_):
        calls = []
        orig = icp_._iter_transform

        def spy(pts):
            calls.append(1)
            return orig(pts)

        icp_._iter_transform = spy
        return calls

    def test_static_points_on_the_cpu_take_the_host_loop(self):
        static = np.random.default_rng(4).uniform(-1, 1, (100, 3)).astype(np.float32)
        icp_ = IterativeClosestPoint(static)
        calls = self._spy(icp_)
        icp_.register_points(static + 0.01)
        assert len(calls) >= 1

    def test_the_card_takes_the_device_loop_unless_settings_changed(self, monkeypatch):
        """Changed settings no longer send the card to the host loop: they go
        to the device loop as run-time arguments."""
        static = np.random.default_rng(4).uniform(-1, 1, (100, 3)).astype(np.float32)
        icp_ = IterativeClosestPoint(static)
        calls = self._spy(icp_)
        monkeypatch.setattr(icp_._nn, "device", torch.device("meta"))  # not the CPU
        ran = []
        monkeypatch.setattr(icp, "register_points_torch",
                            lambda *a, **k: ran.append((a[2], k)) or (torch.zeros(1), torch.eye(4)))
        icp_.register_points(static + 0.01)
        icp_.max_iterations = 5
        icp_.good_correspondence_distance = 0.02
        icp_.converged_maximum_translation = 2e-4
        icp_.converged_maximum_rotation = 3e-5
        icp_.register_points(static + 0.01)
        assert calls == [] and len(ran) == 2
        (it0, kw0), (it1, kw1) = ran
        assert it0 == icp.MAX_ITERATIONS and it1 == 5
        assert kw0["good_correspondence_distance"] == icp.GOOD_CORRESPONDENCE_DISTANCE
        assert (kw1["good_correspondence_distance"], kw1["converged_maximum_translation"],
                kw1["converged_maximum_rotation"]) == (0.02, 2e-4, 3e-5)

    def test_modified_thresholds_run_on_the_device_loop(self):
        """parity=False with changed thresholds runs the device loop and
        lands where the host loop does, within 1e-4."""
        static = np.random.default_rng(4).uniform(-1, 1, (100, 3)).astype(np.float32)
        icp_ = IterativeClosestPoint(static)
        icp_.good_correspondence_distance = 0.02
        calls = self._spy(icp_)
        a_dev, tf_dev = icp_.register_points(static + 0.01, parity=False)
        assert calls == []
        a_par, tf_par = icp_.register_points(static + 0.01, parity=True)
        assert len(calls) >= 1
        np.testing.assert_allclose(a_dev, a_par, atol=1e-4)
        np.testing.assert_allclose(tf_dev, tf_par, atol=1e-4)

    @pytest.mark.parametrize("settings", [
        {"good_correspondence_distance": 0.002},
        {"good_correspondence_distance": 0.1},
        {"converged_maximum_translation": 1e-2, "converged_maximum_rotation": 1e-3},
        {"converged_maximum_translation": 0.0, "converged_maximum_rotation": 0.0},
        {"max_iterations": 2},
    ], ids=["good_0.002", "good_0.1", "loose_convergence", "never_converged", "two_iterations"])
    def test_device_loop_with_changed_settings_matches_the_host_loop(self, settings,
                                                                      monkeypatch):
        """The device loop reads the thresholds and ``max_iterations`` at run
        time: with each changed it stops where the host loop stops and lands
        within PERF.md's 1e-4 of it (a cloud moved by a rotation and a
        translation, so that several iterations run)."""
        rng = np.random.default_rng(11)
        static = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
        moved = apply(static, rot_x(0.03) @ rot_y(-0.02) @ translation(0.02, -0.015, 0.01))
        icp_ = IterativeClosestPoint(static)
        for name, value in settings.items():
            setattr(icp_, name, value)
        host_iters = self._spy(icp_)
        a_par, tf_par = icp_.register_points(moved, parity=True)
        searches = []
        search = icp.nearest_neighbors
        monkeypatch.setattr(icp, "nearest_neighbors",
                            lambda *a, **k: searches.append(1) or search(*a, **k))
        with torch.no_grad():
            aligned, total = register_points_torch(
                torch.from_numpy(static), torch.from_numpy(moved), icp_.max_iterations,
                good_correspondence_distance=icp_.good_correspondence_distance,
                converged_maximum_translation=icp_.converged_maximum_translation,
                converged_maximum_rotation=icp_.converged_maximum_rotation)
        # One search an iteration: the device loop stops where the host loop does.
        assert len(searches) == len(host_iters) <= icp_.max_iterations
        a_dev, tf_dev = icp_.register_points(moved, parity=False)
        np.testing.assert_array_equal(a_dev, aligned.numpy())
        np.testing.assert_allclose(a_dev, a_par, atol=1e-4)
        np.testing.assert_allclose(tf_dev, tf_par, atol=1e-4)


class TestGridNN:
    """The grid index answers exactly as the brute-force kernel: same indices,
    same recomputed distances."""

    def _same_as_brute(self, pts, q, grid=None):
        grid = grid or GridNN(pts)
        assert grid.ok
        gi, gd = grid.query(q)
        bi, bd = nearest_neighbors(torch.from_numpy(pts), q)
        np.testing.assert_array_equal(gi.numpy(), bi.numpy())
        np.testing.assert_array_equal(gd.numpy(), bd.numpy())
        return gi.numpy(), gd.numpy()

    def test_identical_to_brute_force_uniform(self):
        rng = np.random.default_rng(3)
        pts = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
        q = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
        gi, gd = self._same_as_brute(pts, q)
        # ... and as the JAX package's grid index.
        ji, jd = jicp.GridNN(pts).query(q)
        assert_indices_match_jax(gi, ji, pts, q)
        np.testing.assert_allclose(gd, jd, rtol=2e-7)

    def test_identical_on_clustered_and_outlier_queries(self):
        rng = np.random.default_rng(4)
        pts = np.concatenate([rng.normal(0, 1.0, (5000, 3)), rng.normal(2, 1.0, (5000, 3)),
                              rng.uniform(-3, 3, (500, 3))]).astype(np.float32)
        q = np.concatenate([rng.normal(0, 0.1, (500, 3)),
                            rng.uniform(-20, 20, (100, 3))]).astype(np.float32)
        self._same_as_brute(pts, q)

    def test_query_chunks_give_the_same_answers(self, monkeypatch):
        rng = np.random.default_rng(11)
        pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
        grid = GridNN(pts)
        a, _ = grid.query(q)
        monkeypatch.setattr(icp, "GRID_QUERY_CANDIDATES", 27 * grid.K * 7)  # 72 chunks
        b, _ = grid.query(q)
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_degenerate_clustering_declines(self):
        rng = np.random.default_rng(7)
        pts = np.concatenate([rng.normal(0, 0.01, (5000, 3)),
                              rng.uniform(-3, 3, (200, 3))]).astype(np.float32)
        assert not GridNN(pts, max_bucket=10**6).ok
        assert not jicp.GridNN(pts, max_bucket=10**6).ok

    def test_the_bucket_cap_declines_as_the_jax_package(self):
        rng = np.random.default_rng(12)
        pts = np.concatenate([rng.normal(0, 0.05, (400, 3)),
                              rng.uniform(-1, 1, (3000, 3))]).astype(np.float32)
        for cap in (16, 64, 128, 512):
            assert GridNN(pts, max_bucket=cap).ok == jicp.GridNN(pts, max_bucket=cap).ok

    def test_nearest_neighbors_class_routes_large_sets(self):
        rng = np.random.default_rng(5)
        pts = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        brute = NearestNeighbors(pts, grid_min_points=10**9)
        grid = NearestNeighbors(pts, grid_min_points=1)
        bp, bdist = brute.search(q)
        gp, gdist = grid.search(q)
        assert brute.grid() is None and grid.grid().ok
        np.testing.assert_array_equal(bp, gp)
        np.testing.assert_array_equal(bdist, gdist)

    def test_icp_registration_matches_brute_on_fixture(self):
        rng = np.random.default_rng(6)
        static = rng.uniform(-1, 1, (6000, 3)).astype(np.float32)
        ang = 0.02
        r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     np.float32)
        moved = static @ r.T + np.array([0.01, -0.02, 0.015], np.float32)
        icp_b = IterativeClosestPoint(static)
        icp_b._nn._grid_min = 10**9
        icp_g = IterativeClosestPoint(static)
        icp_g._nn._grid_min = 1
        pb, tb = icp_b.register_points(moved, parity=True)
        pg, tg = icp_g.register_points(moved, parity=True)
        np.testing.assert_allclose(tb, tg, atol=1e-6)
        np.testing.assert_allclose(pb, pg, atol=1e-5)

    def test_a_declined_index_refuses_queries(self):
        grid = GridNN(np.zeros((3000, 3), np.float32))
        assert not grid.ok
        with pytest.raises(ValueError, match="declined"):
            grid.query(np.zeros((1, 3), np.float32))


class TestGridScanIcp:
    """The grid index inside the device loop: the brute loop's trajectory,
    gradients, chunked queries."""

    def _fixture(self, n=4000, m=2000, seed=1):
        rng = np.random.default_rng(seed)
        static = rng.random((n, 3)).astype(np.float32) * 2 - 1
        ang = 0.05
        r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     np.float32)
        return static, static[:m] @ r.T + np.array([0.02, -0.015, 0.01], np.float32)

    def test_matches_brute_scan_exactly(self):
        static, moved = self._fixture()
        ab, tb = register_points_torch(static, moved, nn="brute")
        ag, tg = register_points_torch(static, moved, nn="grid")
        np.testing.assert_allclose(tg.numpy(), tb.numpy(), atol=2e-6)
        np.testing.assert_allclose(ag.numpy(), ab.numpy(), atol=2e-5)
        # ... and the JAX package's grid scan.
        _, jt = jicp.register_points_jax(static, moved, nn="grid")
        np.testing.assert_allclose(tg.numpy(), np.asarray(jt), atol=1e-4)

    def test_matches_host_loop(self):
        static, moved = self._fixture(seed=2)
        ag, tg = register_points_torch(static, moved, nn="grid")
        _, th = IterativeClosestPoint(static).register_points(moved, parity=True)
        np.testing.assert_allclose(tg.numpy(), th, atol=5e-4)
        assert np.abs(ag.numpy() - static[:2000]).max() < 5e-3

    def test_gradient_flows_through_grid_scan(self):
        static, moved = self._fixture()
        mv = torch.from_numpy(moved).requires_grad_()
        a, _ = register_points_torch(static, mv, max_iterations=6, nn="grid")
        torch.sum((a - torch.from_numpy(static[:2000])) ** 2).backward()
        assert bool(torch.isfinite(mv.grad).all())

    def test_doubtful_queries_in_chunks_match_brute(self, monkeypatch):
        static, moved = self._fixture(seed=3)
        moved = moved + np.float32(0.5)  # misaligned: many doubtful queries
        grid = GridNN(static)
        assert int((~grid._grid_pass(torch.from_numpy(moved))[1]).sum()) > 8
        _, t1 = register_points_torch(static, moved, nn="brute")
        _, t2 = register_points_torch(static, moved, nn="grid", grid=grid)
        # Query chunks of 37 points: every iteration's search runs in 55 pieces.
        monkeypatch.setattr(icp, "GRID_QUERY_CANDIDATES", 27 * grid.K * 37)
        passes = []
        grid_pass = grid._grid_pass
        monkeypatch.setattr(grid, "_grid_pass", lambda q: passes.append(len(q)) or grid_pass(q))
        _, t3 = register_points_torch(static, moved, nn="grid", grid=grid)
        assert passes and len(passes) % 55 == 0 and max(passes) == 37
        np.testing.assert_allclose(t2.numpy(), t1.numpy(), atol=2e-5)
        np.testing.assert_array_equal(t3.numpy(), t2.numpy())

    def test_auto_takes_the_grid_past_the_threshold(self, monkeypatch):
        static, moved = self._fixture()
        built = []
        real = icp.GridNN

        def spy(*a, **k):
            built.append(1)
            return real(*a, **k)

        monkeypatch.setattr(icp, "GridNN", spy)
        register_points_torch(static, moved, max_iterations=2)
        assert built == []
        monkeypatch.setattr(icp, "GRID_NN_MIN_POINTS", 1000)
        register_points_torch(static, moved, max_iterations=2)
        assert built == [1]

    def test_grid_mode_errors_on_degenerate_build(self):
        pts = np.zeros((3000, 3), np.float32)
        with pytest.raises(ValueError, match="grid NN index declined"):
            register_points_torch(pts, pts[:10], nn="grid")


class TestGridNNEdgeCases:
    def test_single_query_and_duplicate_points(self):
        rng = np.random.default_rng(9)
        base = rng.random((3000, 3)).astype(np.float32)
        pts = np.concatenate([base, base[:500]])
        grid = GridNN(pts)
        assert grid.ok
        q = base[250:251] + np.float32(1e-4)
        gi, _ = grid.query(q)
        bi, _ = nearest_neighbors(torch.from_numpy(pts), q)
        assert gi.tolist() == bi.tolist() == [250]  # not the duplicate at 3250

    def test_all_queries_one_cell(self):
        rng = np.random.default_rng(10)
        pts = rng.random((4000, 3)).astype(np.float32)
        grid = GridNN(pts)
        assert grid.ok
        q = np.float32(0.5) + rng.random((grid.K * 40, 3)).astype(np.float32) * np.float32(1e-3)
        gi, _ = grid.query(q)
        bi, _ = nearest_neighbors(torch.from_numpy(pts), q)
        np.testing.assert_array_equal(gi.numpy(), bi.numpy())
