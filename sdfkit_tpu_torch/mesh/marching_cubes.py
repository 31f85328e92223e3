"""Lewiner MC33 marching cubes with colour interpolation.

Counterpart of ``sdfkit_tpu/mesh/marching_cubes.py``. Reference:
SdfKit/MarchingCubes.cs + Cell.cs + Luts.cs (ported there from scikit-image's
_marching_cubes_lewiner_cy.pyx): the same case/subcase dispatch with
face/internal ambiguity tests in float64 (FLT_EPSILON = 1e-7,
MarchingCubes.cs:37), inverse-|value| vertex and colour interpolation
(Cell.cs:272-359), gradient accumulation into normals with the reference's
packed-index/MC-corner quirk (Cell.cs:453-498) and first-occurrence vertex
order, so the reference's golden vertex counts hold.

The split between the volume's device and the host:

* **Dense phase, on the volume's device, as torch ops.** Each z-slab's active
  cells (mixed corner signs) come from eight strided slices of the value
  grid; ``torch.nonzero`` takes their flat ids in ascending (z, y, x) order;
  eight offset ORs mark the unique corner points, whose values a boolean
  index compacts in ascending point id. One copy takes both to the host.
* **Sparse phase, on the host, in C++** (``sdfkit_tpu_torch/native``): case
  dispatch, welding, interpolation, gradient normals, world transform.
* **Colour blends, on the device**, gathered from the resident value and
  colour grids in float32 while the host accumulates the normals.

The JAX package's link machinery (packed bitmaps, a chunked point-value
pipeline, float16 colours) served a 10-30 MB/s TPU link and is left out.
Every disagreement between host and device raises; nothing falls back.

``create_mesh_numpy`` is the plain numpy version of the whole algorithm (the
JAX package's vectorized sparse phase, ``_sparse_phase``), the oracle the
tests and ``chip_smoke.py`` hold ``create_mesh`` to. ``create_mesh`` never
calls it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sdfkit_tpu_torch import native
from sdfkit_tpu_torch.mesh import luts
from sdfkit_tpu_torch.mesh.mesh import Mesh

FLT_EPSILON = 1e-7  # MarchingCubes.cs:37, Cell.cs:63

# z-slabs of the dense sweep: progress fires per z layer as each slab's
# classification is queued.
N_PROGRESS_SLABS = 8

# Wall-clock of the last create_mesh call by phase (ms), each interval ending
# at a copy that synchronises with the device.
LAST_TIMINGS: dict = {}

_CORNERS = tuple(zip(luts.CORNER_DX.tolist(), luts.CORNER_DY.tolist(), luts.CORNER_DZ.tolist()))


def _empty_mesh() -> Mesh:
    return Mesh(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0))


def _visited(n: int, step: int) -> int:
    """Visited cell coordinates per axis: the multiples of ``step`` strictly
    below ``n - step`` (the reference's ``z = -step; while (z < n - 2*step)
    { z += step; ... }`` loops, MarchingCubes.cs:53-66)."""
    return len(range(0, n - step, step))


def _host_bounds(vmin, vmax):
    """(size, center) as float64, from the float32 bounds with the JAX
    package's float32 arithmetic (``Voxels.host_bounds``)."""
    vmin = np.asarray(torch.as_tensor(vmin).detach().cpu(), np.float32)
    vmax = np.asarray(torch.as_tensor(vmax).detach().cpu(), np.float32)
    return (vmax - vmin).astype(np.float64), ((vmin + vmax) * np.float32(0.5)).astype(np.float64)


def _classify_slab(values, iso: float, z0: int, step: int, lx: int, ly: int, m: int):
    """Active-cell mask of the ``m`` cell layers from grid z ``z0``, shape
    (m, ly, lx) in the reference's (z, y, x) order. A cell is active iff its
    eight corners are neither all above nor all at-or-below ``iso`` (case 0 is
    bits 0 and 255 exactly). ``value > iso`` in float32 is exact, as the
    reference's ``v - iso > 0`` in double is."""
    above_any = above_all = None
    for dx, dy, dz in _CORNERS:
        x, y, z = dx * step, dy * step, z0 + dz * step
        corner = values[x:x + (lx - 1) * step + 1:step, y:y + (ly - 1) * step + 1:step,
                        z:z + (m - 1) * step + 1:step]
        above = corner > iso
        if above_any is None:
            above_any, above_all = above, above.clone()
        else:
            above_any |= above
            above_all &= above
    return (above_any & ~above_all).permute(2, 1, 0)


def _point_mask(mask):
    """The (lz+1, ly+1, lx+1) mask of the unique corner points of the active
    cells (``mask``: (lz, ly, lx)): a point is set iff any of the up-to-8
    cells it corners is active."""
    lz, ly, lx = mask.shape
    pm = torch.zeros((lz + 1, ly + 1, lx + 1), dtype=torch.bool, device=mask.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                pm[dz:dz + lz, dy:dy + ly, dx:dx + lx] |= mask
    return pm


def _edge_offsets(ny: int, nz: int, step: int):
    """Flat grid offsets of each edge's two endpoints from the cell's base
    corner, and of the eight corners (x-major (nx, ny, nz) grid)."""
    def flat(rx, ry, rz):
        return ((rx.astype(np.int64) * ny + ry) * nz + rz) * step

    return (flat(luts.edgesrelx[:, 0], luts.edgesrely[:, 0], luts.edgesrelz[:, 0]),
            flat(luts.edgesrelx[:, 1], luts.edgesrely[:, 1], luts.edgesrelz[:, 1]),
            flat(luts.CORNER_DX, luts.CORNER_DY, luts.CORNER_DZ))


def _edge_vertex_colors(v1, v2, c1, c2, iso: float):
    """Edge-vertex colours from the values (v1, v2) and colours (c1, c2) at
    the edges' two endpoints: the inverse-|value| weights (Cell.cs:298-311)
    recomputed in float32 (at most an ulp from the host's float64 weights)."""
    t1 = 1.0 / (FLT_EPSILON + (v1 - iso).abs())
    t2 = 1.0 / (FLT_EPSILON + (v2 - iso).abs())
    w = (t1 / (t1 + t2))[:, None]
    return c1 * w + c2 * (1.0 - w)


def _center_vertex_colors(v8, c8, iso: float):
    """Centre-vertex (v12) colours from the values (n, 8) and colours
    (n, 8, 3) at the cells' eight corners: their inverse-|value| weighted
    blend (Cell.CalculateCenterVertex, Cell.cs:501-549)."""
    s = 1.0 / (FLT_EPSILON + (v8 - iso).abs())
    w = s / s.sum(dim=1, keepdim=True)
    return (c8 * w[:, :, None]).sum(dim=1)


def create_mesh(voxels, iso_value: float = 0.0, step: int = 1, progress=None) -> Mesh:
    """The iso-surface mesh of ``voxels`` (MarchingCubes.CreateMesh,
    MarchingCubes.cs:39-92): the dense phase and the colour blends on the
    volume's device, the sparse phase in C++ on the host."""
    with torch.no_grad():
        return _create_mesh(voxels, iso_value, int(step), progress)


def _create_mesh(voxels, iso_value: float, step: int, progress) -> Mesh:
    # iso quantised to float32 so the device's float32 compare and the
    # host's float64 subtraction of two float32 values see the same signs.
    iso = float(np.float32(iso_value))
    values = voxels.values.detach().to(torch.float32)
    colors = voxels.colors.detach().to(torch.float32)
    nx, ny, nz = values.shape
    lx, ly, lz = _visited(nx, step), _visited(ny, step), _visited(nz, step)
    nz_bound = max(nz - 2 * step, 1)
    LAST_TIMINGS.clear()

    if progress is not None:
        progress(0.0)
    if lx == 0 or ly == 0 or lz == 0:
        if progress is not None:
            progress(1.0)
        return _empty_mesh()
    if nx * ny * nz >= 2**31:
        raise NotImplementedError("the colour blends' flat grid ids are int32: a grid of "
                                  f"{nx * ny * nz} samples needs int64 ids")
    # The bounds first, before the device queue fills: a small copy.
    size_center = _host_bounds(voxels.vmin, voxels.vmax)

    t0 = time.perf_counter()
    slab = max(1, -(-lz // N_PROGRESS_SLABS))
    parts = []
    for s0 in range(0, lz, slab):
        m = min(slab, lz - s0)
        parts.append(_classify_slab(values, iso, s0 * step, step, lx, ly, m))
        if progress is not None:
            for cz in range(s0, s0 + m):
                progress(float(cz * step) / nz_bound)
    mask = torch.cat(parts) if len(parts) > 1 else parts[0]
    del parts
    active = torch.nonzero(mask.reshape(-1)).squeeze(1)  # synchronises
    LAST_TIMINGS["dense_classify_ms"] = (time.perf_counter() - t0) * 1e3
    if active.numel() == 0:
        return _empty_mesh()

    points = values[0:lx * step + 1:step, 0:ly * step + 1:step, 0:lz * step + 1:step]
    pvals = points.permute(2, 1, 0)[_point_mask(mask)]
    del mask
    return sparse_phase(active, pvals, values.shape, step, iso, size_center,
                        grid_reader(values, colors), values.device)


def sparse_phase(active, pvals, shape, step: int, iso: float, size_center, read,
                 device) -> Mesh:
    """The mesh from the active cells' flat (z, y, x) ids and the values of
    their unique corner points in ascending point id (device tensors): one
    copy to the host, the C++ sparse phase, and the colour blends on
    ``device`` through ``read`` (see ``_blend_colors``)."""
    nx, ny, nz = shape
    lx, ly, lz = _visited(nx, step), _visited(ny, step), _visited(nz, step)
    t0 = time.perf_counter()
    n_active, n_points = active.numel(), pvals.numel()
    # One copy to the host: the int64 ids and the float32 values as int32 words.
    wire = torch.cat([active.view(torch.int32), pvals.view(torch.int32)]).cpu().numpy()
    active_h = wire[:2 * n_active].view(np.int64)
    pvals_h = wire[2 * n_active:].view(np.float32)
    LAST_TIMINGS["fetch_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with native.McSparse(active_h, lx, ly, lz, nx, ny, nz, step, iso) as mc:
        if mc.expected_points() != n_points:
            raise RuntimeError(f"the device marked {n_points} corner points and the host "
                               f"index expects {mc.expected_points()}")
        LAST_TIMINGS["native_index_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        mc.geometry(pvals_h)
        LAST_TIMINGS["native_geometry_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        vcols = _blend_colors(read, shape, device, mc.color_inputs(), mc.n_verts, step, iso)
        LAST_TIMINGS["color_ms"] = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        verts, normals, stream = mc.grad_finalize(*size_center)
        LAST_TIMINGS["grad_finalize_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    vcols_h = vcols.cpu().numpy()
    LAST_TIMINGS["colors_wait_ms"] = (time.perf_counter() - t0) * 1e3
    return Mesh(verts, vcols_h, normals, stream)


def grid_reader(values, colors):
    """``read(ids) -> (values, colours)`` at flat ids of the resident grids."""
    values_flat = values.reshape(-1)
    colors_flat = colors.reshape(-1, 3)
    return lambda ids: (values_flat[ids], colors_flat[ids])


def _blend_colors(read, shape, device, ci: dict, n_verts: int, step: int, iso: float):
    """Queue the vertex colour blends on ``device``; returns the (n_verts, 3)
    float32 colours there, not yet synchronised. ``read(ids)`` gives the
    values and colours at flat ids of the (nx, ny, nz) grid ``shape``: the
    edge vertices' two endpoints, then the centre vertices' eight corners, in
    one call (``grid_reader`` on one device; the sharded mesh reads the
    ranks' bricks)."""
    _, ny, nz = shape
    off1, off2, deltas = (torch.from_numpy(a).to(device) for a in _edge_offsets(ny, nz, step))

    def up(name):
        return torch.from_numpy(ci[name].astype(np.int64)).to(device)

    n_edge, n_center = ci["edge_vid"].size, ci["center_vid"].size
    parts = []
    if n_edge:
        base, vi = up("edge_base"), up("edge_vi")
        parts += [base + off1[vi], base + off2[vi]]
    if n_center:
        parts.append((up("center_base")[:, None] + deltas[None, :]).reshape(-1))
    vcols = torch.zeros((n_verts, 3), dtype=torch.float32, device=device)
    if not parts:
        return vcols
    vals, cols = read(torch.cat(parts))
    if n_edge:
        e = slice(0, n_edge), slice(n_edge, 2 * n_edge)
        vcols[up("edge_vid")] = _edge_vertex_colors(vals[e[0]], vals[e[1]], cols[e[0]],
                                                    cols[e[1]], iso)
    if n_center:
        c = slice(2 * n_edge, None)
        vcols[up("center_vid")] = _center_vertex_colors(
            vals[c].view(n_center, 8), cols[c].view(n_center, 8, 3), iso)
    return vcols


# ---------------------------------------------------------------------------
# The numpy oracle: the JAX package's vectorized sparse phase, whole.
# ---------------------------------------------------------------------------


def _test_face(face, v8):
    """Vectorized MarchingCubes.TestFace (MarchingCubes.cs:376-407).

    face: (m,) int array of signed face ids; v8: (8, m) corner values.
    Returns (m,) bool.
    """
    face = np.asarray(face, np.int64)
    corners = luts.FACE_CORNERS[np.abs(face)]  # (m, 4)
    m = np.arange(face.shape[0])
    A = v8[corners[:, 0], m]
    B = v8[corners[:, 1], m]
    C = v8[corners[:, 2], m]
    D = v8[corners[:, 3], m]
    ac_bd = A * C - B * D
    near_zero = (ac_bd > -FLT_EPSILON) & (ac_bd < FLT_EPSILON)
    return np.where(near_zero, face >= 0, face * A * ac_bd >= 0)


def _test_internal(cas, s, v8, edge=None):
    """Vectorized MarchingCubes.TestInternal (MarchingCubes.cs:412-546).

    cas: python int (4, 6, 7, 10, 12 or 13); s: (m,) signed test values;
    edge: (m,) reference edge for cases 6/7/12/13. Returns (m,) bool.
    """
    s = np.asarray(s, np.float64)
    m = s.shape[0]
    idx = np.arange(m)

    if cas in (4, 10):
        a = (v8[4] - v8[0]) * (v8[6] - v8[2]) - (v8[7] - v8[3]) * (v8[5] - v8[1])
        b = (
            v8[2] * (v8[4] - v8[0])
            + v8[0] * (v8[6] - v8[2])
            - v8[1] * (v8[7] - v8[3])
            - v8[3] * (v8[5] - v8[1])
        )
        t = -b / (2.0 * a + FLT_EPSILON)
        early = (t < 0) | (t > 1)
        At = v8[0] + (v8[4] - v8[0]) * t
        Bt = v8[3] + (v8[7] - v8[3]) * t
        Ct = v8[2] + (v8[6] - v8[2]) * t
        Dt = v8[1] + (v8[5] - v8[1]) * t
    else:
        edge = np.asarray(edge, np.int64)
        va = v8[luts.INT_T[edge, 0], idx]
        vb = v8[luts.INT_T[edge, 1], idx]
        t = va / (va - vb + FLT_EPSILON)
        early = np.zeros(m, bool)
        At = np.zeros(m)

        def interp(tab):
            x0 = v8[tab[edge, 0], idx]
            x1 = v8[tab[edge, 1], idx]
            return x0 + (x1 - x0) * t

        Bt = interp(luts.INT_B)
        Ct = interp(luts.INT_C)
        Dt = interp(luts.INT_D)

    test = (
        (At >= 0).astype(np.int64)
        + 2 * (Bt >= 0).astype(np.int64)
        + 4 * (Ct >= 0).astype(np.int64)
        + 8 * (Dt >= 0).astype(np.int64)
    )
    # Outcome per test nibble (MarchingCubes.cs:526-545): True means "s>0
    # wins". tests {0..4,6,8,9,12} -> s>0; {7,11,13,14,15} -> s<0; 5 and 10
    # depend on the saddle product sign.
    saddle = At * Ct - Bt * Dt
    pos = np.isin(test, (0, 1, 2, 3, 4, 6, 8, 9, 12))
    pos |= (test == 5) & (saddle < FLT_EPSILON)
    pos |= (test == 10) & (saddle >= FLT_EPSILON)
    result = np.where(pos, s > 0, s < 0)
    return np.where(early, s > 0, result)


def _dispatch(casenum, config, v8):
    """Vectorized TheBigSwitch (MarchingCubes.cs:94-371).

    casenum, config: (m,) int arrays for active cells; v8: (8, m) float64.
    Returns a list of (cell_indices, vi_rows) where vi_rows is
    (len(cell_indices), 3*nt) of edge indices 0..12.
    """
    groups = []

    def emit(sel, lut, cfg, nt, sub=None):
        if sel.size == 0:
            return
        rows = lut[cfg, : 3 * nt] if sub is None else lut[cfg, sub, : 3 * nt]
        groups.append((sel, rows))

    def faces_of(sel, face_ids):
        return _test_face(face_ids, v8[:, sel])

    for cas in range(1, 15):
        mask = casenum == cas
        if not mask.any():
            continue
        sel = np.nonzero(mask)[0]
        cfg = config[sel]

        if cas == 1:
            emit(sel, luts.tiling1, cfg, 1)
        elif cas == 2:
            emit(sel, luts.tiling2, cfg, 2)
        elif cas == 3:
            t = faces_of(sel, luts.test3[cfg])
            emit(sel[t], luts.tiling3_2, cfg[t], 4)
            emit(sel[~t], luts.tiling3_1, cfg[~t], 2)
        elif cas == 4:
            t = _test_internal(4, luts.test4[cfg], v8[:, sel])
            emit(sel[t], luts.tiling4_1, cfg[t], 2)
            emit(sel[~t], luts.tiling4_2, cfg[~t], 6)
        elif cas == 5:
            emit(sel, luts.tiling5, cfg, 3)
        elif cas == 6:
            f = faces_of(sel, luts.test6[cfg, 0])
            emit(sel[f], luts.tiling6_2, cfg[f], 5)
            s2, c2 = sel[~f], cfg[~f]
            ti = _test_internal(6, luts.test6[c2, 1], v8[:, s2], edge=luts.test6[c2, 2])
            emit(s2[ti], luts.tiling6_1_1, c2[ti], 3)
            emit(s2[~ti], luts.tiling6_1_2, c2[~ti], 9)
        elif cas == 7:
            sub = (
                faces_of(sel, luts.test7[cfg, 0]).astype(np.int64)
                + 2 * faces_of(sel, luts.test7[cfg, 1]).astype(np.int64)
                + 4 * faces_of(sel, luts.test7[cfg, 2]).astype(np.int64)
            )
            m0 = sub == 0
            emit(sel[m0], luts.tiling7_1, cfg[m0], 3)
            for sc, k in ((1, 0), (2, 1), (4, 2)):
                mk = sub == sc
                emit(sel[mk], luts.tiling7_2, cfg[mk], 5, sub=k)
            for sc, k in ((3, 0), (5, 1), (6, 2)):
                mk = sub == sc
                emit(sel[mk], luts.tiling7_3, cfg[mk], 9, sub=k)
            m7 = sub == 7
            s7, c7 = sel[m7], cfg[m7]
            ti = _test_internal(7, luts.test7[c7, 3], v8[:, s7], edge=luts.test7[c7, 4])
            emit(s7[ti], luts.tiling7_4_2, c7[ti], 9)
            emit(s7[~ti], luts.tiling7_4_1, c7[~ti], 5)
        elif cas == 8:
            emit(sel, luts.tiling8, cfg, 2)
        elif cas == 9:
            emit(sel, luts.tiling9, cfg, 4)
        elif cas in (10, 12):
            test_t = luts.test10 if cas == 10 else luts.test12
            t11_ = luts.tiling10_1_1_ if cas == 10 else luts.tiling12_1_1_
            t2 = luts.tiling10_2 if cas == 10 else luts.tiling12_2
            t2_ = luts.tiling10_2_ if cas == 10 else luts.tiling12_2_
            t11 = luts.tiling10_1_1 if cas == 10 else luts.tiling12_1_1
            t12 = luts.tiling10_1_2 if cas == 10 else luts.tiling12_1_2
            f0 = faces_of(sel, test_t[cfg, 0])
            f1 = faces_of(sel, test_t[cfg, 1])
            m_a = f0 & f1
            m_b = f0 & ~f1
            m_c = ~f0 & f1
            m_d = ~f0 & ~f1
            emit(sel[m_a], t11_, cfg[m_a], 4)
            emit(sel[m_b], t2, cfg[m_b], 8)
            emit(sel[m_c], t2_, cfg[m_c], 8)
            sd, cd = sel[m_d], cfg[m_d]
            if cas == 10:
                ti = _test_internal(10, test_t[cd, 2], v8[:, sd])
            else:
                ti = _test_internal(12, test_t[cd, 2], v8[:, sd], edge=test_t[cd, 3])
            emit(sd[ti], t11, cd[ti], 4)
            emit(sd[~ti], t12, cd[~ti], 8)
        elif cas == 11:
            emit(sel, luts.tiling11, cfg, 4)
        elif cas == 13:
            bits = np.zeros(sel.shape[0], np.int64)
            for b in range(6):
                bits += (1 << b) * faces_of(sel, luts.test13[cfg, b]).astype(np.int64)
            sub = luts.subconfig13[bits].astype(np.int64)
            m0 = sub == 0
            emit(sel[m0], luts.tiling13_1, cfg[m0], 4)
            for sc in range(1, 7):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_2, cfg[mk], 6, sub=sc - 1)
            for sc in range(7, 19):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_3, cfg[mk], 10, sub=sc - 7)
            for sc in range(19, 23):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_4, cfg[mk], 12, sub=sc - 19)
            for sc in range(23, 27):
                mk = sub == sc
                sk, ck = sel[mk], cfg[mk]
                s2 = sc - 23
                edge = luts.tiling13_5_1[ck, s2, 0]
                ti = _test_internal(13, luts.test13[ck, 6], v8[:, sk], edge=edge)
                emit(sk[ti], luts.tiling13_5_1, ck[ti], 6, sub=np.full(ti.sum(), s2))
                emit(sk[~ti], luts.tiling13_5_2, ck[~ti], 10, sub=np.full((~ti).sum(), s2))
            for sc in range(27, 39):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_3_, cfg[mk], 10, sub=sc - 27)
            for sc in range(39, 45):
                mk = sub == sc
                emit(sel[mk], luts.tiling13_2_, cfg[mk], 6, sub=sc - 39)
            m45 = sub == 45
            emit(sel[m45], luts.tiling13_1_, cfg[m45], 4)
        elif cas == 14:
            emit(sel, luts.tiling14, cfg, 4)

    return groups


def _corner_gradients(v8):
    """Per-cell corner gradients vg (Cell.PrepareForAddingTriangles,
    Cell.cs:486-498), MC corner numbering, shape (8, m, 3) float32. The
    differences are taken in float32."""
    v0, v1, v2, v3, v4, v5, v6, v7 = v8.astype(np.float32)
    gx = np.stack([v0 - v1, v0 - v1, v3 - v2, v3 - v2, v4 - v5, v4 - v5, v7 - v6, v7 - v6])
    gy = np.stack([v0 - v3, v1 - v2, v1 - v2, v0 - v3, v4 - v7, v5 - v6, v5 - v6, v4 - v7])
    gz = np.stack([v0 - v4, v1 - v5, v2 - v6, v3 - v7, v0 - v4, v1 - v5, v2 - v6, v3 - v7])
    return np.stack([gx, gy, gz], axis=2)


def _finalize_geometry(verts, normals, dims, size_center):
    """Negative normalized normals (Cell.cs:97-109) and the index->world
    transform (MarchingCubes.cs:84-91). ``verts``: float64 index-space
    positions; ``normals``: float32 accumulated gradients. Returns (float32
    world vertices, float32 unit normals)."""
    normals = normals.astype(np.float64)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = -normals / np.where(norm > 0, norm, 1.0)
    size, center = size_center
    n = np.array(dims, np.float64)
    scale = size / (n - 1)
    verts = (verts - (n - 1) / 2.0) * scale + center
    normals = normals / scale
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(nn > 0, nn, 1.0)
    return verts.astype(np.float32), normals.astype(np.float32)


def create_mesh_numpy(values, colors, vmin, vmax, iso_value: float = 0.0, step: int = 1) -> Mesh:
    """The whole of marching cubes in numpy on host arrays: the oracle for
    :func:`create_mesh`. ``values``: (nx, ny, nz), ``colors``: (nx, ny, nz, 3),
    ``vmin`` / ``vmax``: (3,)."""
    values = np.ascontiguousarray(values, np.float32)
    colors = np.ascontiguousarray(colors, np.float32)
    iso = float(np.float32(iso_value))
    step = int(step)
    nx, ny, nz = values.shape
    lx, ly, lz = _visited(nx, step), _visited(ny, step), _visited(nz, step)
    if lx == 0 or ly == 0 or lz == 0:
        return _empty_mesh()

    # Per cell and MC corner k, the corner's flat grid id.
    cx = np.arange(lx, dtype=np.int64) * step
    cy = np.arange(ly, dtype=np.int64) * step
    cz = np.arange(lz, dtype=np.int64) * step
    base = (cx[None, None, :] * ny + cy[None, :, None]) * nz + cz[:, None, None]  # (z, y, x)
    _, _, deltas = _edge_offsets(ny, nz, step)
    flat = values.reshape(-1)
    iso_f = np.float32(iso)
    bits = np.zeros(base.shape, np.int64)
    for k in range(8):
        bits += (flat[base + deltas[k]] > iso_f).astype(np.int64) << k
    bits = bits.reshape(-1)
    active = np.flatnonzero((bits != 0) & (bits != 255))
    if active.size == 0:
        return _empty_mesh()
    ids = base.reshape(-1)[active][None, :] + deltas[:, None]  # (8, m)
    return _sparse_phase(values, colors, _host_bounds(vmin, vmax), active, bits[active],
                         flat[ids], step, lx, ly, iso)


def _sparse_phase(values, colors, size_center, active, case_index, v8, step: int, lx: int,
                  ly: int, iso: float = 0.0) -> Mesh:
    """Case dispatch, vertex welding, interpolation, gradient normals, world
    transform, and the colour blends, in numpy. ``active``: flat (z, y, x)
    visited-cell indices; ``v8``: (8, m) float32 corner values in MC corner
    numbering."""
    nx, ny, nz = values.shape
    casenum = luts.cases[case_index, 0].astype(np.int64)
    config = luts.cases[case_index, 1].astype(np.int64)

    acx = (active % lx) * step
    acy = ((active // lx) % ly) * step
    acz = (active // (lx * ly)) * step

    # Iso-subtracted in float64, as in the reference's double-typed Cell
    # (Cell.cs:191-233): the subtraction of two float32 values is exact.
    v8 = np.asarray(v8, np.float64) - iso

    def corner_of(rel_dx, rel_dy, rel_dz):
        packed = rel_dz.astype(np.int64) * 4 + rel_dy * 2 + rel_dx
        return luts.OFFSET_TO_MC[packed].astype(np.int64)

    # --- dispatch and the face stream in reference order ---
    groups = _dispatch(casenum, config, v8)
    n_active = active.size
    lens = np.zeros(n_active, np.int64)
    for sel, rows in groups:
        lens[sel] = rows.shape[1]
    offsets = np.concatenate([[0], np.cumsum(lens)])
    total = offsets[-1]
    stream_vi = np.zeros(total, np.int64)
    stream_cell = np.zeros(total, np.int64)
    for sel, rows in groups:
        pos = offsets[sel][:, None] + np.arange(rows.shape[1])[None, :]
        stream_vi[pos] = rows
        stream_cell[pos] = sel[:, None]

    # --- welding by canonical edge keys, first occurrence first ---
    svi = stream_vi
    kx = acx[stream_cell] + step * luts.KEY_OX[svi]
    ky = acy[stream_cell] + step * luts.KEY_OY[svi]
    kz = acz[stream_cell] + step * luts.KEY_OZ[svi]
    keys = ((kz.astype(np.int64) * ny + ky) * nx + kx) * 4 + luts.KEY_J[svi]
    _, first_idx, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    vertex_id = rank[inv.reshape(-1)]
    rep = first_idx[order]

    # --- vertex positions (float64) and colours (float32) ---
    n_verts = rep.size
    verts = np.zeros((n_verts, 3))
    vcols = np.zeros((n_verts, 3), np.float32)
    r_vi = stream_vi[rep]
    r_cell = stream_cell[rep]
    r_cx, r_cy, r_cz = acx[r_cell], acy[r_cell], acz[r_cell]
    flat_values = values.reshape(-1)
    flat_colors = colors.reshape(-1, 3)
    off1, off2, deltas = _edge_offsets(ny, nz, step)
    eps32 = np.float32(FLT_EPSILON)

    edge_m = r_vi < 12
    if edge_m.any():
        evi = r_vi[edge_m]
        cells = r_cell[edge_m]
        ex, ey, ez = r_cx[edge_m], r_cy[edge_m], r_cz[edge_m]
        rel1 = [t[evi, 0] for t in (luts.edgesrelx, luts.edgesrely, luts.edgesrelz)]
        rel2 = [t[evi, 1] for t in (luts.edgesrelx, luts.edgesrely, luts.edgesrelz)]
        va = v8[corner_of(*rel1), cells]
        vb = v8[corner_of(*rel2), cells]
        t1 = 1.0 / (FLT_EPSILON + np.abs(va))
        t2 = 1.0 / (FLT_EPSILON + np.abs(vb))
        ff = t1 + t2
        for d, c in enumerate((ex, ey, ez)):
            verts[edge_m, d] = c + step * (rel1[d] * t1 + rel2[d] * t2) / ff

        base_e = (ex * ny + ey) * nz + ez
        i1, i2 = base_e + off1[evi], base_e + off2[evi]
        w1 = np.float32(1.0) / (eps32 + np.abs(flat_values[i1] - np.float32(iso)))
        w2 = np.float32(1.0) / (eps32 + np.abs(flat_values[i2] - np.float32(iso)))
        w = (w1 / (w1 + w2))[:, None]
        vcols[edge_m] = flat_colors[i1] * w + flat_colors[i2] * (np.float32(1.0) - w)

    center_m = ~edge_m
    if center_m.any():
        cc = r_cell[center_m]
        strength = 1.0 / (FLT_EPSILON + np.abs(v8[:, cc]))
        ff = strength.sum(axis=0)
        for d, (c, dd) in enumerate(zip((r_cx, r_cy, r_cz),
                                        (luts.CORNER_DX, luts.CORNER_DY, luts.CORNER_DZ))):
            verts[center_m, d] = c[center_m] + step * (strength * dd[:, None]).sum(axis=0) / ff

        base_c = (r_cx[center_m] * ny + r_cy[center_m]) * nz + r_cz[center_m]
        ids = base_c[:, None] + deltas[None, :]
        s = np.float32(1.0) / (eps32 + np.abs(flat_values[ids] - np.float32(iso)))
        w = s / s.sum(axis=1, keepdims=True)
        vcols[center_m] = (flat_colors[ids] * w[:, :, None]).sum(axis=1)

    # --- gradient accumulation into normals (every face reference
    #     contributes; Cell.AddGradient* with the vg packed-vs-MC indexing
    #     quirk, Cell.cs:314-333), float32 as the reference's Vector3 ---
    vg = _corner_gradients(v8)
    normals = np.zeros((n_verts, 3), np.float32)
    se_m = svi < 12
    if se_m.any():
        # A reference's contribution depends only on its (cell, edge) pair:
        # compress the stream to unique pairs and scale by multiplicity.
        evi_all = svi[se_m]
        ecell_all = stream_cell[se_m]
        _, uidx, ucnt = np.unique(ecell_all * 13 + evi_all, return_index=True,
                                  return_counts=True)
        evi = evi_all[uidx]
        ecell = ecell_all[uidx]
        uvid = vertex_id[se_m][uidx]
        va = v8[luts.EDGE_MC1[evi], ecell]
        vb = v8[luts.EDGE_MC2[evi], ecell]
        cnt = ucnt.astype(np.float32)
        t1 = (cnt / (FLT_EPSILON + np.abs(va))).astype(np.float32)
        t2 = (cnt / (FLT_EPSILON + np.abs(vb))).astype(np.float32)
        contrib = (vg[luts.EDGE_P1[evi], ecell] * t1[:, None]
                   + vg[luts.EDGE_P2[evi], ecell] * t2[:, None])
        np.add.at(normals, uvid, contrib)
    sc_m = ~se_m
    if sc_m.any():
        ccell = stream_cell[sc_m]
        strength = (1.0 / (FLT_EPSILON + np.abs(v8[:, ccell]))).astype(np.float32)
        contrib = np.einsum("kc,kcd->cd", strength, vg[:, ccell])
        np.add.at(normals, vertex_id[sc_m], contrib)

    fverts, fnormals = _finalize_geometry(verts, normals, (nx, ny, nz), size_center)
    return Mesh(fverts, vcols, fnormals, vertex_id.astype(np.int32))
