"""Lewiner MC33 lookup tables as numpy arrays.

Data generated from the reference's tables (SdfKit/Luts.cs, themselves from
scikit-image's _marching_cubes_lewiner_luts.py) by tools/gen_luts.py.
"""

from __future__ import annotations

import numpy as np

from sdfkit_tpu_torch.mesh import _luts_data as _d


def _a(name, dtype=np.int8):
    return np.array(getattr(_d, name), dtype=dtype)


edgesrelx = _a("edgesrelx")
edgesrely = _a("edgesrely")
edgesrelz = _a("edgesrelz")
cases = _a("cases")

tiling1 = _a("tiling1")
tiling2 = _a("tiling2")
test3 = _a("test3")
tiling3_1 = _a("tiling3_1")
tiling3_2 = _a("tiling3_2")
test4 = _a("test4")
tiling4_1 = _a("tiling4_1")
tiling4_2 = _a("tiling4_2")
tiling5 = _a("tiling5")
test6 = _a("test6")
tiling6_1_1 = _a("tiling6_1_1")
tiling6_1_2 = _a("tiling6_1_2")
tiling6_2 = _a("tiling6_2")
test7 = _a("test7")
tiling7_1 = _a("tiling7_1")
tiling7_2 = _a("tiling7_2")
tiling7_3 = _a("tiling7_3")
tiling7_4_1 = _a("tiling7_4_1")
tiling7_4_2 = _a("tiling7_4_2")
tiling8 = _a("tiling8")
tiling9 = _a("tiling9")
test10 = _a("test10")
tiling10_1_1 = _a("tiling10_1_1")
tiling10_1_1_ = _a("tiling10_1_1_")
tiling10_1_2 = _a("tiling10_1_2")
tiling10_2 = _a("tiling10_2")
tiling10_2_ = _a("tiling10_2_")
tiling11 = _a("tiling11")
test12 = _a("test12")
tiling12_1_1 = _a("tiling12_1_1")
tiling12_1_1_ = _a("tiling12_1_1_")
tiling12_1_2 = _a("tiling12_1_2")
tiling12_2 = _a("tiling12_2")
tiling12_2_ = _a("tiling12_2_")
test13 = _a("test13")
subconfig13 = _a("subconfig13")
tiling13_1 = _a("tiling13_1")
tiling13_1_ = _a("tiling13_1_")
tiling13_2 = _a("tiling13_2")
tiling13_2_ = _a("tiling13_2_")
tiling13_3 = _a("tiling13_3")
tiling13_3_ = _a("tiling13_3_")
tiling13_4 = _a("tiling13_4")
tiling13_5_1 = _a("tiling13_5_1")
tiling13_5_2 = _a("tiling13_5_2")
tiling14 = _a("tiling14")

# ---------------------------------------------------------------------------
# Derived tables for the vectorized implementation.
# ---------------------------------------------------------------------------

# MC corner numbering -> (dx, dy, dz) offsets within the cell.
CORNER_DX = np.array([0, 1, 1, 0, 0, 1, 1, 0], np.int8)
CORNER_DY = np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int8)
CORNER_DZ = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int8)

# Packed corner offset (dz*4 + dy*2 + dx) -> MC corner index; the inverse of
# the CORNER_D* tables. Lets the sparse mesh phase look corner values up in
# the per-active-cell (8, n) gather instead of the full grid.
OFFSET_TO_MC = np.zeros(8, np.int8)
OFFSET_TO_MC[
    CORNER_DZ.astype(np.int64) * 4 + CORNER_DY * 2 + CORNER_DX
] = np.arange(8, dtype=np.int8)

# Canonical edge ownership for vertex welding, derived from
# Cell.GetIndexInFacelayer (Cell.cs:371-441): each edge index 0..11 maps to a
# cell offset and one of 4 per-cell slots (0: x-edge, 1: y-edge, 2: z-edge);
# slot 3 is the per-cell center vertex (edge index 12).
KEY_OX = np.array([0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0], np.int8)
KEY_OY = np.array([0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0], np.int8)
KEY_OZ = np.array([0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.int8)
KEY_J = np.array([0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2, 3], np.int8)

# Edge endpoint tables, derived once from edgesrel*: per edge index 0..11,
# the packed offset (dz*4 + dy*2 + dx, Cell.cs:318-319) and the MC corner
# index of each endpoint. The sparse phase's gradient pass indexes the
# MC-numbered per-cell gradients by the PACKED offset — reproducing the
# reference's vg indexing quirk (Cell.cs:314-333) — and the endpoint values
# by MC corner.
EDGE_P1 = (
    edgesrelz[:, 0].astype(np.int64) * 4 + edgesrely[:, 0] * 2 + edgesrelx[:, 0]
)
EDGE_P2 = (
    edgesrelz[:, 1].astype(np.int64) * 4 + edgesrely[:, 1] * 2 + edgesrelx[:, 1]
)
EDGE_MC1 = OFFSET_TO_MC[EDGE_P1].astype(np.int64)
EDGE_MC2 = OFFSET_TO_MC[EDGE_P2].astype(np.int64)

# TestFace corner quads A,B,C,D per |face| 1..6 (MarchingCubes.cs:384-398),
# index 0 unused.
FACE_CORNERS = np.array(
    [
        [0, 0, 0, 0],
        [0, 4, 5, 1],
        [1, 5, 6, 2],
        [2, 6, 7, 3],
        [3, 7, 4, 0],
        [0, 3, 2, 1],
        [4, 7, 6, 5],
    ],
    np.int8,
)

# TestInternal per-edge interpolation tables (MarchingCubes.cs:440-511):
# t = v[T0]/(v[T0]-v[T1]+eps); X = v[X0] + (v[X1]-v[X0])*t for X in B,C,D
# (At is always 0 in the edge branch).
INT_T = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]],
    np.int8,
)
INT_B = np.array(
    [[3, 2], [0, 3], [1, 0], [2, 1], [7, 6], [4, 7], [5, 4], [6, 5],
     [3, 7], [0, 4], [1, 5], [2, 6]],
    np.int8,
)
INT_C = np.array(
    [[7, 6], [4, 7], [5, 4], [6, 5], [3, 2], [0, 3], [1, 0], [2, 1],
     [2, 6], [3, 7], [0, 4], [1, 5]],
    np.int8,
)
INT_D = np.array(
    [[4, 5], [5, 6], [6, 7], [7, 4], [0, 1], [1, 2], [2, 3], [3, 0],
     [1, 5], [2, 6], [3, 7], [0, 4]],
    np.int8,
)
