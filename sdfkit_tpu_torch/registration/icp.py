"""Point-cloud registration: nearest-neighbour search and iterative closest point.

Counterpart of ``sdfkit_tpu/registration/icp.py``. Reference: SdfKit/KdTree.cs
and SdfKit/IterativeClosestPoint.cs. The nearest-neighbour search is exact
and runs on the points' device: a chunked brute-force scan for small clouds
and a uniform grid of buckets past ``GRID_NN_MIN_POINTS``, whose doubtful
answers the brute-force scan gives again. The ICP loop mirrors the
reference: correspondences filtered by the 4-branch robust cutoff keyed to
GoodCorrespondenceDistance (IterativeClosestPoint.cs:94-114), Kabsch SVD with
the determinant fix (169-182), convergence on translation <= 1e-4 and
rotation <= 1e-5 (17-25, 63-73), at most 100 iterations.

Two loops: :class:`IterativeClosestPoint`'s parity loop (float64 numpy each
iteration, the search on the device) and :func:`register_points_torch`
(float32 on the device, differentiable by autograd in both point sets).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from sdfkit_tpu_torch.device import resolve

MAX_ITERATIONS = 100  # IterativeClosestPoint.cs:17
GOOD_CORRESPONDENCE_DISTANCE = 0.01  # IterativeClosestPoint.cs:21
CONVERGED_MAX_TRANSLATION = 1.0e-4  # IterativeClosestPoint.cs:23
CONVERGED_MAX_ROTATION = 1.0e-5  # IterativeClosestPoint.cs:25

GRID_NN_MIN_POINTS = 50_000  # brute force keeps smaller clouds
# Candidates (queries x 27 buckets x the largest bucket) a grid pass holds at
# once: about 0.7 GB of temporaries.
GRID_QUERY_CANDIDATES = 1 << 24


def _as_points(x, device=None) -> torch.Tensor:
    """(N, 3) float32 on ``device``: a tensor's own device when None, else
    the package's default device."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
    else:
        t = torch.as_tensor(np.asarray(x, np.float32), device=resolve(device))
    return t.to(torch.float32).reshape(-1, 3)


@contextlib.contextmanager
def _full_float32_matmul():
    """float32 products without TF32, the analogue of the JAX package's
    ``Precision.HIGHEST``: TF32's 10-bit mantissa loses the low bits that
    decide the argmin between near-equidistant points. The setting is global,
    so the caller's comes back afterwards."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _exact_distances(queries, points, idx):
    """The winner's distance from the direct difference (the reference's
    Vector3.Distance, KdTree.cs:172), not from the expansion."""
    diff = queries - points[idx]
    return torch.sqrt(torch.sum(diff * diff, dim=1))


def nearest_neighbors(points, queries, chunk: int = 2048):
    """Index and distance of each query's nearest point, on the points'
    device (``KdTree.Search(q, out dist)``, KdTree.cs:160-197).

    Scans ``points`` in chunks of ``chunk`` columns with
    ``q^2 - 2 q.p + p^2`` (a float32 product without TF32), keeping a running
    minimum whose ties go to the lowest index. Returns (int64 indices,
    float32 distances) tensors; no gradient flows through them."""
    points = _as_points(points)
    queries = _as_points(queries, points.device)
    n = points.shape[0]
    if n == 0:
        raise ValueError("at least one point must be given")
    chunk = int(min(chunk, n))
    with torch.no_grad(), _full_float32_matmul():
        pts, qs = points.detach(), queries.detach()
        q2 = torch.sum(qs * qs, dim=1)
        best_d2 = torch.full((qs.shape[0],), float("inf"), device=qs.device)
        best_i = torch.zeros(qs.shape[0], dtype=torch.int64, device=qs.device)
        for start in range(0, n, chunk):
            block = pts[start:start + chunk]
            d2 = torch.matmul(qs, block.T).mul_(-2.0)
            d2.add_(q2[:, None]).add_(torch.sum(block * block, dim=1)[None, :])
            dmin, arg = torch.min(d2, dim=1)  # the first minimum on a tie
            better = dmin < best_d2
            best_d2 = torch.where(better, dmin, best_d2)
            best_i = torch.where(better, arg + start, best_i)
        return best_i, _exact_distances(qs, pts, best_i)


class GridNN:
    """Exact nearest-neighbour index over a fixed point set: a uniform grid of
    buckets whose queries gather their 27 neighbouring buckets (the JAX
    package lays the buckets out as flat shifts instead, because gathers are
    slow on the TPU).

    The points are sorted by flat cell id, stably, so each bucket holds its
    points in ascending original index; ``starts`` / ``counts`` locate each
    cell's bucket. A query's answer is the brute-force kernel's, given by
    that kernel itself where the grid could be wrong or could round
    differently: (a) the best distance could be beaten from outside the
    3x3x3 block, (b) the runner-up lies within the near-tie epsilon of the
    winner. Exact ties go to the lowest original index. Buckets have no
    slots, so no query overflows one.

    ``ok`` is False on degenerate clustering, when the densest cell exceeds
    ``max_bucket`` or the JAX package's dense-layout budget
    ``max_dense_bytes`` would be exceeded (the same rule, so both packages
    decline the same clouds); callers then use brute force."""

    def __init__(self, points, target_per_cell: int = 6, max_bucket: int = 128,
                 max_dense_bytes: int = 512 * 1024 * 1024):
        pts = _as_points(points).detach()
        self.points = pts
        n = pts.shape[0]
        self.ok = False
        if n == 0:
            return
        lo = pts.min(dim=0).values
        hi = pts.max(dim=0).values
        G = max(int(np.ceil((n / target_per_cell) ** (1.0 / 3.0))), 1)
        cell = torch.clamp(hi - lo, min=1e-6) / G
        flat = self._flat(self._cell_of(pts, lo, cell, G), G)
        counts = torch.bincount(flat, minlength=G ** 3)
        K = int(counts.max())
        gp = G + 2
        self.ok = (0 < K <= max_bucket and gp ** 3 * K * 16 <= max_dense_bytes
                   and gp ** 3 * K * (K + 8) * 4 <= max_dense_bytes)
        if not self.ok:
            return
        order = torch.sort(flat, stable=True).indices
        self.G, self.K = G, K
        self.lo, self.cell = lo, cell
        self.order = order
        self.sorted_points = pts[order]
        self.counts = counts
        self.starts = torch.cumsum(counts, 0) - counts
        self.offsets = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                                     for dz in (-1, 0, 1)], device=pts.device)

    @staticmethod
    def _cell_of(p, lo, cell, G):
        return torch.clamp(torch.floor((p - lo) / cell).to(torch.int64), 0, G - 1)

    @staticmethod
    def _flat(c, G):
        return (c[..., 0] * G + c[..., 1]) * G + c[..., 2]

    def _grid_pass(self, q):
        """(indices, guaranteed) of queries ``q`` from their 27 buckets."""
        G, K, dev = self.G, self.K, q.device
        qc = self._cell_of(q, self.lo, self.cell, G)  # (n, 3)
        nc = qc[:, None, :] + self.offsets[None, :, :]  # (n, 27, 3)
        inside = ((nc >= 0) & (nc < G)).all(dim=2)
        flat = self._flat(torch.clamp(nc, 0, G - 1), G)
        count = torch.where(inside, self.counts[flat], 0)  # (n, 27)
        slot = torch.arange(K, device=dev)
        cand = self.starts[flat][:, :, None] + slot  # (n, 27, K) sorted positions
        valid = (slot < count[:, :, None]).reshape(q.shape[0], -1)
        cand = torch.where(valid, cand.reshape(q.shape[0], -1), 0)
        diff = q[:, None, :] - self.sorted_points[cand]
        d2 = torch.where(valid, torch.sum(diff * diff, dim=2), float("inf"))
        orig = torch.where(valid, self.order[cand], torch.iinfo(torch.int64).max)
        best = d2.min(dim=1).values
        # The winner: the lowest original index among the minimal distances.
        borig = torch.where(d2 <= best[:, None], orig, torch.iinfo(torch.int64).max).min(1).values
        # Runner-up: leave out ONE minimal position, so an exact duplicate of
        # the winner's distance keeps a copy (a near-tie, repaired below).
        am = d2.argmin(dim=1, keepdim=True)
        best2 = d2.scatter(1, am, float("inf")).min(dim=1).values

        # The nearest point outside the 3x3x3 block is at least this far: per
        # axis the distance to the block's face, infinite where the block is
        # clipped by the data's bounding box.
        low_face = self.lo + (qc.to(torch.float32) - 1.0) * self.cell
        high_face = self.lo + (qc.to(torch.float32) + 2.0) * self.cell
        r_low = torch.where(qc - 1 >= 0, q - low_face, float("inf"))
        r_high = torch.where(qc + 2 <= G, high_face - q, float("inf"))
        r_safe = torch.minimum(r_low, r_high).min(dim=1).values
        in_block = torch.sqrt(best) < r_safe  # boundary ties go to brute force
        # Near-ties go to brute force too, so the two paths agree on them: the
        # brute force expansion loses ~8 ulp of |q|^2 to cancellation.
        tie_eps = 1e-5 * (1.0 + torch.sum(q * q, dim=1))
        return borig, in_block & ((best2 - best) > tie_eps)

    def query(self, queries):
        """Exact nearest neighbours: the grid pass in query chunks of at most
        ``GRID_QUERY_CANDIDATES`` candidates, then brute force for the queries
        it cannot vouch for. Returns (int64 original indices, float32 distances),
        the brute-force kernel's answers, ties and near-ties included."""
        if not self.ok:
            raise ValueError("the grid index declined this point set (see GridNN.ok)")
        q = _as_points(queries, self.points.device).detach()
        per = max(1, GRID_QUERY_CANDIDATES // (27 * self.K))
        with torch.no_grad():
            parts = [self._grid_pass(q[s:s + per]) for s in range(0, q.shape[0], per)]
            idx = torch.cat([p[0] for p in parts])
            ok = torch.cat([p[1] for p in parts])
            bad = torch.nonzero(~ok).squeeze(1)
            if bad.numel():
                idx[bad] = nearest_neighbors(self.points, q[bad])[0]
            return idx, _exact_distances(q, self.points, idx)


class NearestNeighbors:
    """Mutable nearest-neighbour index with the reference KdTree's surface
    (add_points / search): brute force for small clouds, :class:`GridNN` past
    ``GRID_NN_MIN_POINTS``; both give the same answers. The points live on
    ``device`` (the package's default when None); ``search`` takes and
    returns numpy."""

    def __init__(self, points, grid_min_points: int | None = None, device=None):
        self._points = np.asarray(points, np.float32).reshape(-1, 3)
        if len(self._points) == 0:
            raise ValueError("at least one point must be given")
        self.device = resolve(device)
        self._dev = torch.from_numpy(self._points).to(self.device)
        self._grid = None
        self._grid_min = GRID_NN_MIN_POINTS if grid_min_points is None else grid_min_points

    @property
    def total_points(self) -> int:
        return len(self._points)

    @property
    def points(self) -> np.ndarray:
        return self._points

    @property
    def points_device(self) -> torch.Tensor:
        return self._dev

    def add_points(self, points) -> None:
        points = np.asarray(points, np.float32).reshape(-1, 3)
        self._points = np.concatenate([self._points, points], axis=0)
        self._dev = torch.from_numpy(self._points).to(self.device)
        self._grid = None  # rebuilt at its next use

    def grid(self) -> GridNN | None:
        """The cached grid index when the cloud is large enough, else None."""
        if self.total_points < self._grid_min:
            return None
        if self._grid is None:
            self._grid = GridNN(self._dev)
        return self._grid

    def _search(self, q):
        grid = self.grid()
        if grid is not None and grid.ok:
            return grid.query(q)
        return nearest_neighbors(self._dev, q)

    def search(self, query):
        """Nearest point to ``query`` (one (3,) point or an (N, 3) batch).
        Returns (nearest_points, distances)."""
        q = np.asarray(query, np.float32)
        single = q.ndim == 1
        idx, dist = self._search(torch.from_numpy(q.reshape(-1, 3)).to(self.device))
        pts = self._points[idx.cpu().numpy()]
        dist = dist.cpu().numpy()
        if single:
            return pts[0], float(dist[0])
        return pts, dist


KdTree = NearestNeighbors  # the reference's name


def _kabsch(p_centered, q_centered):
    """Rotation 3x3 (row-vector convention, IterativeClosestPoint.cs:149-182):
    r = V diag(1, 1, det) U^T from the SVD of c = sum_i outer(p_i, q_i)."""
    u, _s, vt = np.linalg.svd(p_centered.T @ q_centered)
    v = vt.T
    sd = np.diag([1.0, 1.0, np.sign(np.linalg.det(v @ u.T))])
    return v @ sd @ u.T


def _transform_points(points, m):
    """Row-vector transform: p' = p @ M[:3,:3] + M[3,:3]."""
    return points @ m[:3, :3] + m[3, :3]


def robust_distance_cutoff(dist_mean: float, dist_std: float,
                           good: float = GOOD_CORRESPONDENCE_DISTANCE) -> float:
    """The reference's 4-branch correspondence-distance cutoff
    (IterativeClosestPoint.cs:101-114). The fourth branch is the CODE's
    ``distMean + 0.5f + distStd`` (line 113); the "valley after the maximal
    peak" rule its comment quotes is never computed."""
    if dist_mean < good:
        return dist_mean + 3.0 * dist_std
    if dist_mean < 3.0 * good:
        return dist_mean + 2.0 * dist_std
    if dist_mean < 6.0 * good:
        return dist_mean + dist_std
    return dist_mean + 0.5 + dist_std


class IterativeClosestPoint:
    """Point-to-point ICP against a static point set
    (IterativeClosestPoint.cs:10-205), with the static points on ``device``
    (a tensor's own, else the package's default device)."""

    def __init__(self, static_points, device=None):
        if isinstance(static_points, (list, tuple)):
            if len(static_points) == 0:
                raise ValueError("at least one set of points must be given")
            pts = np.concatenate([np.asarray(_host(p), np.float32).reshape(-1, 3)
                                  for p in static_points])
        else:
            if device is None and isinstance(static_points, torch.Tensor):
                device = static_points.device
            pts = np.asarray(_host(static_points), np.float32).reshape(-1, 3)
        self._nn = NearestNeighbors(pts, device=device)
        self.max_iterations = MAX_ITERATIONS
        self.good_correspondence_distance = GOOD_CORRESPONDENCE_DISTANCE
        self.converged_maximum_translation = CONVERGED_MAX_TRANSLATION
        self.converged_maximum_rotation = CONVERGED_MAX_ROTATION

    def add_static_points(self, points) -> None:
        self._nn.add_points(_host(points))

    def register_points(self, points, parity: bool | None = None):
        """Rigidly align ``points`` to the static set. Returns (aligned
        points, total transform) as float32 numpy; the transform is the 4x4
        row-vector matrix that maps the input points to their aligned places
        (IterativeClosestPoint.cs:53-75).

        ``parity``: True runs the host loop that mirrors the reference step
        for step (float64 numpy, early exit), with the search on the device.
        False runs :func:`register_points_torch` on the device. None takes the
        host loop when the static points are on the CPU and the device loop
        otherwise. Both loops read ``max_iterations`` and the three thresholds
        at run time."""
        if parity is None:
            parity = self._nn.device.type == "cpu"
        if not parity:
            with torch.no_grad():
                aligned, total = register_points_torch(
                    self._nn.points_device, _as_points(points, self._nn.device),
                    self.max_iterations, grid=self._nn.grid(),
                    good_correspondence_distance=self.good_correspondence_distance,
                    converged_maximum_translation=self.converged_maximum_translation,
                    converged_maximum_rotation=self.converged_maximum_rotation)
            return aligned.cpu().numpy(), total.cpu().numpy()

        pts = np.asarray(_host(points), np.float32).reshape(-1, 3).copy()
        total = np.eye(4, dtype=np.float32)
        for _ in range(self.max_iterations):
            transform = self._iter_transform(pts)
            pts = _transform_points(pts, transform).astype(np.float32)
            drot = (abs(1.0 - transform[0, 0]) + abs(1.0 - transform[1, 1])
                    + abs(1.0 - transform[2, 2]))
            dtrans = float(np.linalg.norm(transform[3, :3]))
            total = total @ transform
            if (dtrans <= self.converged_maximum_translation
                    and drot <= self.converged_maximum_rotation):
                break
        return pts, total

    def _iter_transform(self, pts) -> np.ndarray:
        """One ICP iteration (GetIterTransform, IterativeClosestPoint.cs:77-205).
        Returns the 4x4 applied transform."""
        cor, dist = self._nn.search(pts)
        dist = np.asarray(dist, np.float64)
        dist_mean = dist.mean()
        dist_std = float(np.sqrt(((dist - dist_mean) ** 2).mean()))
        dist_max = robust_distance_cutoff(dist_mean, dist_std, self.good_correspondence_distance)

        keep = dist <= dist_max
        p = np.asarray(pts, np.float64)[keep]
        q = np.asarray(cor, np.float64)[keep]
        pmean = p.mean(axis=0)
        qmean = q.mean(axis=0)
        r4 = np.eye(4)
        r4[:3, :3] = _kabsch(p - pmean, q - qmean)
        translation = pmean @ np.linalg.inv(r4)[:3, :3] - qmean
        t4 = np.eye(4)
        t4[3, :3] = translation
        return np.linalg.inv(r4 @ t4).astype(np.float32)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def register_points_torch(static_points, points, max_iterations: int = MAX_ITERATIONS,
                          nn: str = "auto", grid: GridNN | None = None,
                          good_correspondence_distance: float = GOOD_CORRESPONDENCE_DISTANCE,
                          converged_maximum_translation: float = CONVERGED_MAX_TRANSLATION,
                          converged_maximum_rotation: float = CONVERGED_MAX_ROTATION):
    """ICP on the static points' device in float32, differentiable by
    autograd with respect to both point sets. Returns (aligned points, total
    transform) tensors. The counterpart of the JAX package's
    ``register_points_jax``: the same per-iteration math, and an exit after
    the iteration that converges (one boolean read on the host each
    iteration) where the JAX scan freezes its carry.

    Gradients flow through the gathered correspondences and the SVD; the
    nearest-neighbour indices and the keep mask are piecewise constant.

    ``nn``: 'brute' scans every static point each iteration; 'grid' uses the
    exact :class:`GridNN` (``grid`` if given, a new one otherwise) and raises
    when it declines; 'auto' takes the grid past ``GRID_NN_MIN_POINTS`` when
    it builds. Every choice gives the same correspondences.

    The correspondence cutoff's ``good_correspondence_distance`` and the
    convergence thresholds are read at run time, as the host loop of
    :meth:`IterativeClosestPoint.register_points` reads them."""
    static_points = _as_points(static_points)
    points = _as_points(points, static_points.device)
    if nn not in ("auto", "brute", "grid"):
        raise ValueError(f"unknown nn mode {nn!r}")
    search = functools.partial(nearest_neighbors, static_points)
    if nn == "grid" or (nn == "auto" and static_points.shape[0] >= GRID_NN_MIN_POINTS):
        if grid is None:
            grid = GridNN(static_points)
        if grid.ok:
            search = grid.query
        elif nn == "grid":
            raise ValueError(
                "grid NN index declined (a bucket exceeds max_bucket — degenerate "
                "clustering — or the dense bucket budget exceeds max_dense_bytes); "
                "use nn='brute' or 'auto'")

    eye4 = torch.eye(4, dtype=torch.float32, device=static_points.device)
    good = float(good_correspondence_distance)
    pts, total = points, eye4
    with _full_float32_matmul():
        for _ in range(int(max_iterations)):
            cor = static_points[search(pts)[0]]
            with torch.no_grad():
                diff = pts - cor
                dist = torch.sqrt(torch.sum(diff * diff, dim=1))
                dist_mean = dist.mean()
                dist_std = torch.sqrt(((dist - dist_mean) ** 2).mean())
                dist_max = torch.where(
                    dist_mean < good, dist_mean + 3.0 * dist_std,
                    torch.where(dist_mean < 3.0 * good, dist_mean + 2.0 * dist_std,
                                torch.where(dist_mean < 6.0 * good, dist_mean + dist_std,
                                            dist_mean + 0.5 + dist_std)))
                w = (dist <= dist_max).to(torch.float32)
                wsum = torch.clamp(w.sum(), min=1.0)
            pmean = (pts * w[:, None]).sum(0) / wsum
            qmean = (cor * w[:, None]).sum(0) / wsum
            c = (w[:, None] * (pts - pmean)).T @ (cor - qmean)
            u, _s, vt = torch.linalg.svd(c)
            v = vt.T
            det_sign = torch.sign(torch.linalg.det(v @ u.T))
            sd = torch.diag(torch.stack([det_sign.new_ones(()), det_sign.new_ones(()), det_sign]))
            r = v @ sd @ u.T

            r4 = eye4.clone()
            r4[:3, :3] = r
            t4 = eye4.clone()
            t4[3, :3] = pmean @ torch.linalg.inv(r4)[:3, :3] - qmean
            transform = torch.linalg.inv(r4 @ t4)
            pts = pts @ transform[:3, :3] + transform[3, :3]
            total = total @ transform
            with torch.no_grad():
                drot = (transform[0, 0] - 1.0).abs() + (transform[1, 1] - 1.0).abs() \
                    + (transform[2, 2] - 1.0).abs()
                done = ((torch.linalg.vector_norm(transform[3, :3])
                         <= converged_maximum_translation)
                        & (drot <= converged_maximum_rotation))
            if bool(done):
                break
    return pts, total


def global_register_points(scans):
    """Chain-register scans: the first is the static base, and each
    registered scan joins the static set
    (IterativeClosestPoint.GlobalRegisterPoints, IterativeClosestPoint.cs:207-238).
    Returns (aligned_scans, transforms) as float32 numpy."""
    scans = [np.asarray(_host(s), np.float32).reshape(-1, 3) for s in scans]
    if len(scans) == 0:
        return [], []
    if len(scans) == 1:
        return [scans[0]], [np.eye(4, dtype=np.float32)]
    icp = IterativeClosestPoint(scans[0])
    aligned = [scans[0]]
    transforms = [np.eye(4, dtype=np.float32)]
    for scan in scans[1:]:
        out, tf = icp.register_points(scan)
        aligned.append(out)
        transforms.append(tf)
        icp.add_static_points(out)
    return aligned, transforms
