// Marching-cubes host kernels (C++, plain C ABI, loaded with ctypes).
//
// The port's copy of sdfkit_tpu/native/mc_host.cc, less the bitmap decoders
// and the chunked point-value entry points that served the TPU link. Two
// entry groups:
//
// 1. mc_sparse_index / _geometry / _color_inputs / _grad_finalize / _free —
//    the host sparse phase. The card's dense phase hands over only the
//    active-cell flat indices and the values of the UNIQUE grid points
//    touched by active cells. This code rebuilds the per-cell corner values
//    through a bitmap+rank index, then runs the sparse geometry — MC33 case
//    dispatch with face/internal ambiguity tests, first-occurrence vertex
//    welding, inverse-|value| vertex interpolation, and gradient-normal
//    accumulation. It is a scalar transliteration of the vectorized numpy
//    sparse phase (mesh/marching_cubes.py _dispatch/_test_face/
//    _test_internal/_sparse_phase), itself behavior-pinned to the reference
//    (SdfKit/MarchingCubes.cs TheBigSwitch + Cell.cs); the numpy phase stays
//    the parity oracle (tests/test_torch_marching_cubes.py).
//
// 2. mc_sequential_baseline — a single-threaded per-cell loop over the FULL
//    grid that mirrors the REFERENCE's meshing cost structure
//    (MarchingCubes.cs:53-80: per-cell 8-value + 8-color SetCube, LUT case
//    dispatch, rolling face-layer vertex dedup, inverse-|value| interpolation
//    and gradient normals, Cell.cs:123-359): the measured stand-in for the
//    reference's own sequential meshing (a C++ loop is, if anything, faster
//    than the C# original — beating it is conservative).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "_mc_luts.h"

namespace {

constexpr double FLT_EPS = 1e-7;  // MarchingCubes.cs:37

// ---------------------------------------------------------------------------
// Scalar MC33 ambiguity tests (transliterated from mesh/marching_cubes.py
// _test_face/_test_internal; same formulas/order as MarchingCubes.cs:376-546).
// ---------------------------------------------------------------------------

inline bool test_face(int face, const double* v) {
    int af = face < 0 ? -face : face;
    const int8_t* q = FACE_CORNERS + af * FACE_CORNERS_S0;
    const double A = v[q[0]], B = v[q[1]], C = v[q[2]], D = v[q[3]];
    const double acbd = A * C - B * D;
    if (acbd > -FLT_EPS && acbd < FLT_EPS) return face >= 0;
    return static_cast<double>(face) * A * acbd >= 0;
}

inline bool test_internal(int cas, double s, const double* v, int edge) {
    double t, At, Bt, Ct, Dt;
    bool early = false;
    if (cas == 4 || cas == 10) {
        const double a = (v[4] - v[0]) * (v[6] - v[2])
                       - (v[7] - v[3]) * (v[5] - v[1]);
        const double b = v[2] * (v[4] - v[0]) + v[0] * (v[6] - v[2])
                       - v[1] * (v[7] - v[3]) - v[3] * (v[5] - v[1]);
        t = -b / (2.0 * a + FLT_EPS);
        if (t < 0.0 || t > 1.0) early = true;
        At = v[0] + (v[4] - v[0]) * t;
        Bt = v[3] + (v[7] - v[3]) * t;
        Ct = v[2] + (v[6] - v[2]) * t;
        Dt = v[1] + (v[5] - v[1]) * t;
    } else {
        const double va = v[INT_T[edge * INT_T_S0 + 0]];
        const double vb = v[INT_T[edge * INT_T_S0 + 1]];
        t = va / (va - vb + FLT_EPS);
        At = 0.0;
        const double b0 = v[INT_B[edge * INT_B_S0 + 0]];
        const double b1 = v[INT_B[edge * INT_B_S0 + 1]];
        Bt = b0 + (b1 - b0) * t;
        const double c0 = v[INT_C[edge * INT_C_S0 + 0]];
        const double c1 = v[INT_C[edge * INT_C_S0 + 1]];
        Ct = c0 + (c1 - c0) * t;
        const double d0 = v[INT_D[edge * INT_D_S0 + 0]];
        const double d1 = v[INT_D[edge * INT_D_S0 + 1]];
        Dt = d0 + (d1 - d0) * t;
    }
    const int test = (At >= 0 ? 1 : 0) + (Bt >= 0 ? 2 : 0)
                   + (Ct >= 0 ? 4 : 0) + (Dt >= 0 ? 8 : 0);
    const double saddle = At * Ct - Bt * Dt;
    bool pos;
    switch (test) {
        case 0: case 1: case 2: case 3: case 4: case 6: case 8: case 9:
        case 12:
            pos = true;
            break;
        case 5:
            pos = saddle < FLT_EPS;
            break;
        case 10:
            pos = saddle >= FLT_EPS;
            break;
        default:
            pos = false;
    }
    const bool result = pos ? (s > 0) : (s < 0);
    return early ? (s > 0) : result;
}

// TheBigSwitch, per cell: tiling row + triangle count for (casenum, config)
// given the 8 iso-subtracted corner values. Returns nullptr for case 0.
inline const int8_t* dispatch_cell(int casenum, int cfg, const double* v,
                                   int* nt) {
    switch (casenum) {
        case 1: *nt = 1; return TILING1 + cfg * TILING1_S0;
        case 2: *nt = 2; return TILING2 + cfg * TILING2_S0;
        case 3:
            if (test_face(TEST3[cfg], v)) {
                *nt = 4; return TILING3_2 + cfg * TILING3_2_S0;
            }
            *nt = 2; return TILING3_1 + cfg * TILING3_1_S0;
        case 4:
            if (test_internal(4, TEST4[cfg], v, 0)) {
                *nt = 2; return TILING4_1 + cfg * TILING4_1_S0;
            }
            *nt = 6; return TILING4_2 + cfg * TILING4_2_S0;
        case 5: *nt = 3; return TILING5 + cfg * TILING5_S0;
        case 6: {
            const int8_t* t6 = TEST6 + cfg * TEST6_S0;
            if (test_face(t6[0], v)) {
                *nt = 5; return TILING6_2 + cfg * TILING6_2_S0;
            }
            if (test_internal(6, t6[1], v, t6[2])) {
                *nt = 3; return TILING6_1_1 + cfg * TILING6_1_1_S0;
            }
            *nt = 9; return TILING6_1_2 + cfg * TILING6_1_2_S0;
        }
        case 7: {
            const int8_t* t7 = TEST7 + cfg * TEST7_S0;
            const int sub = (test_face(t7[0], v) ? 1 : 0)
                          + (test_face(t7[1], v) ? 2 : 0)
                          + (test_face(t7[2], v) ? 4 : 0);
            switch (sub) {
                case 0: *nt = 3; return TILING7_1 + cfg * TILING7_1_S0;
                case 1: *nt = 5;
                    return TILING7_2 + cfg * TILING7_2_S0 + 0 * TILING7_2_S1;
                case 2: *nt = 5;
                    return TILING7_2 + cfg * TILING7_2_S0 + 1 * TILING7_2_S1;
                case 4: *nt = 5;
                    return TILING7_2 + cfg * TILING7_2_S0 + 2 * TILING7_2_S1;
                case 3: *nt = 9;
                    return TILING7_3 + cfg * TILING7_3_S0 + 0 * TILING7_3_S1;
                case 5: *nt = 9;
                    return TILING7_3 + cfg * TILING7_3_S0 + 1 * TILING7_3_S1;
                case 6: *nt = 9;
                    return TILING7_3 + cfg * TILING7_3_S0 + 2 * TILING7_3_S1;
                default:  // 7
                    if (test_internal(7, t7[3], v, t7[4])) {
                        *nt = 9; return TILING7_4_2 + cfg * TILING7_4_2_S0;
                    }
                    *nt = 5; return TILING7_4_1 + cfg * TILING7_4_1_S0;
            }
        }
        case 8: *nt = 2; return TILING8 + cfg * TILING8_S0;
        case 9: *nt = 4; return TILING9 + cfg * TILING9_S0;
        case 10: {
            const int8_t* tt = TEST10 + cfg * TEST10_S0;
            const bool f0 = test_face(tt[0], v);
            const bool f1 = test_face(tt[1], v);
            if (f0 && f1) {
                *nt = 4; return TILING10_1_1_ + cfg * TILING10_1_1__S0;
            }
            if (f0 && !f1) {
                *nt = 8; return TILING10_2 + cfg * TILING10_2_S0;
            }
            if (!f0 && f1) {
                *nt = 8; return TILING10_2_ + cfg * TILING10_2__S0;
            }
            if (test_internal(10, tt[2], v, 0)) {
                *nt = 4; return TILING10_1_1 + cfg * TILING10_1_1_S0;
            }
            *nt = 8; return TILING10_1_2 + cfg * TILING10_1_2_S0;
        }
        case 11: *nt = 4; return TILING11 + cfg * TILING11_S0;
        case 12: {
            const int8_t* tt = TEST12 + cfg * TEST12_S0;
            const bool f0 = test_face(tt[0], v);
            const bool f1 = test_face(tt[1], v);
            if (f0 && f1) {
                *nt = 4; return TILING12_1_1_ + cfg * TILING12_1_1__S0;
            }
            if (f0 && !f1) {
                *nt = 8; return TILING12_2 + cfg * TILING12_2_S0;
            }
            if (!f0 && f1) {
                *nt = 8; return TILING12_2_ + cfg * TILING12_2__S0;
            }
            if (test_internal(12, tt[2], v, tt[3])) {
                *nt = 4; return TILING12_1_1 + cfg * TILING12_1_1_S0;
            }
            *nt = 8; return TILING12_1_2 + cfg * TILING12_1_2_S0;
        }
        case 13: {
            const int8_t* t13 = TEST13 + cfg * TEST13_S0;
            int bits = 0;
            for (int b = 0; b < 6; ++b)
                if (test_face(t13[b], v)) bits |= 1 << b;
            const int sub = SUBCONFIG13[bits];
            if (sub == 0) {
                *nt = 4; return TILING13_1 + cfg * TILING13_1_S0;
            }
            if (sub >= 1 && sub <= 6) {
                *nt = 6;
                return TILING13_2 + cfg * TILING13_2_S0
                     + (sub - 1) * TILING13_2_S1;
            }
            if (sub >= 7 && sub <= 18) {
                *nt = 10;
                return TILING13_3 + cfg * TILING13_3_S0
                     + (sub - 7) * TILING13_3_S1;
            }
            if (sub >= 19 && sub <= 22) {
                *nt = 12;
                return TILING13_4 + cfg * TILING13_4_S0
                     + (sub - 19) * TILING13_4_S1;
            }
            if (sub >= 23 && sub <= 26) {
                const int s2 = sub - 23;
                const int8_t* row51 = TILING13_5_1 + cfg * TILING13_5_1_S0
                                    + s2 * TILING13_5_1_S1;
                if (test_internal(13, t13[6], v, row51[0])) {
                    *nt = 6; return row51;
                }
                *nt = 10;
                return TILING13_5_2 + cfg * TILING13_5_2_S0
                     + s2 * TILING13_5_2_S1;
            }
            if (sub >= 27 && sub <= 38) {
                *nt = 10;
                return TILING13_3_ + cfg * TILING13_3__S0
                     + (sub - 27) * TILING13_3__S1;
            }
            if (sub >= 39 && sub <= 44) {
                *nt = 6;
                return TILING13_2_ + cfg * TILING13_2__S0
                     + (sub - 39) * TILING13_2__S1;
            }
            *nt = 4;  // sub == 45
            return TILING13_1_ + cfg * TILING13_1__S0;
        }
        case 14: *nt = 4; return TILING14 + cfg * TILING14_S0;
        default: *nt = 0; return nullptr;
    }
}

// Per-cell corner gradients (MC numbering), f32 of the f64 corner values —
// matches _corner_gradients in mesh/marching_cubes.py.
inline void corner_gradients(const double* v8, float g[8][3]) {
    float v[8];
    for (int k = 0; k < 8; ++k) v[k] = static_cast<float>(v8[k]);
    const float gx[8] = {v[0] - v[1], v[0] - v[1], v[3] - v[2], v[3] - v[2],
                         v[4] - v[5], v[4] - v[5], v[7] - v[6], v[7] - v[6]};
    const float gy[8] = {v[0] - v[3], v[1] - v[2], v[1] - v[2], v[0] - v[3],
                         v[4] - v[7], v[5] - v[6], v[5] - v[6], v[4] - v[7]};
    const float gz[8] = {v[0] - v[4], v[1] - v[5], v[2] - v[6], v[3] - v[7],
                         v[0] - v[4], v[1] - v[5], v[2] - v[6], v[3] - v[7]};
    for (int k = 0; k < 8; ++k) {
        g[k][0] = gx[k];
        g[k][1] = gy[k];
        g[k][2] = gz[k];
    }
}

// First-occurrence welding hash map: int64 key -> int32 rank, linear probing,
// power-of-two capacity, grow-on-load. Key -1 = empty (real keys are >= 0).
struct WeldMap {
    std::vector<int64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask = 0;
    int64_t used = 0;

    void init(int64_t expected) {
        uint64_t n = 64;
        while (n < static_cast<uint64_t>(expected) * 2) n <<= 1;
        keys.assign(n, -1);
        vals.assign(n, 0);
        mask = n - 1;
        used = 0;
    }
    void grow() {
        std::vector<int64_t> ok(std::move(keys));
        std::vector<int32_t> ov(std::move(vals));
        const uint64_t n = (mask + 1) << 1;
        keys.assign(n, -1);
        vals.assign(n, 0);
        mask = n - 1;
        for (uint64_t i = 0; i < ok.size(); ++i) {
            if (ok[i] < 0) continue;
            uint64_t h = static_cast<uint64_t>(ok[i]) * 0x9E3779B97F4A7C15ull;
            uint64_t s = (h >> 32) & mask;
            while (keys[s] >= 0) s = (s + 1) & mask;
            keys[s] = ok[i];
            vals[s] = ov[i];
        }
    }
    // Returns rank; sets *fresh if the key was newly inserted with next_rank.
    int32_t lookup_or_insert(int64_t key, int32_t next_rank, bool* fresh) {
        if (used * 4 >= static_cast<int64_t>(mask + 1) * 3) grow();
        uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull;
        uint64_t s = (h >> 32) & mask;
        while (true) {
            if (keys[s] < 0) {
                keys[s] = key;
                vals[s] = next_rank;
                ++used;
                *fresh = true;
                return next_rank;
            }
            if (keys[s] == key) {
                *fresh = false;
                return vals[s];
            }
            s = (s + 1) & mask;
        }
    }
};

struct McResult {
    std::vector<double> verts;       // (V, 3) index-space
    std::vector<float> normals;      // (V, 3) accumulated (un-normalized)
    std::vector<int32_t> stream;     // vertex id per stream entry (triangles)
    std::vector<uint8_t> stream_vi;  // edge index per stream entry
    std::vector<int32_t> stream_cell;  // active-cell row per stream entry
    std::vector<int32_t> edge_vid, edge_base;
    std::vector<uint8_t> edge_vi;
    std::vector<int32_t> center_vid, center_base;
    int64_t n_verts = 0;
    WeldMap weld;       // persists across geometry chunks (threaded merge)
    std::vector<int64_t> layers;  // rolling-layer weld slots (direct path)
    int geo_mode = 0;   // 0 = undecided, 1 = direct, 2 = threaded (pinned
                        // on the first geometry call: the two paths keep
                        // different dedup state, so chunks must not mix)
    bool grad_inlined = false;  // direct path accumulates normals inline
    int32_t next_rank = 0;
    // State for the deferred gradient pass (mc_sparse_grad_finalize):
    std::vector<int64_t> active;
    std::vector<float> pvals;
    std::vector<uint64_t> bm;
    std::vector<int32_t> rank;
    int64_t lx = 0, ly = 0, lz = 0, nx = 0, ny = 0, nz = 0, step = 1;
    double iso = 0.0;
};

}  // namespace

extern "C" {

// The fast sparse phase, part 1 (see file header): bitmap/rank corner
// reconstruction + MC33 dispatch + first-occurrence welding + vertex
// interpolation. Gradient-normal accumulation and the world-space finalize
// are DEFERRED to mc_sparse_grad_finalize so the caller can launch the
// on-device vertex-color blends in between — the color transfer then
// overlaps the gradient pass. Inputs:
//   active:  (n_active) int64 flat cell ids in (z, y, x) visited-cell order
//   pvals:   (n_points) f32 values of the unique corner points, compacted in
//            ascending point-flat-id order, pid = (pz*(ly+1)+py)*(lx+1)+px
//            (point coords in cell units)
//   lx/ly/lz: visited-cell counts per axis;  nx/ny/nz: grid dims
// Phase A: the bitmap/rank corner index needs only the active-cell ids.
// Returns a handle to pass to mc_sparse_geometry (or mc_sparse_free), or
// nullptr if any active id is outside [0, lx*ly*lz) — an out-of-range id
// would index past the corner bitmap below. (The value-count consistency check lives in
// mc_sparse_geometry, which is where the point values first appear.)
void* mc_sparse_index(const int64_t* active, int64_t n_active,
                      int64_t lx, int64_t ly, int64_t lz,
                      int64_t nx, int64_t ny, int64_t nz,
                      int64_t step, double iso) {
    const int64_t px_n = lx + 1, py_n = ly + 1;
    const int64_t P = px_n * py_n * (lz + 1);
    const int64_t words = (P + 63) / 64;
    const int64_t n_cells = lx * ly * lz;
    for (int64_t i = 0; i < n_active; ++i)
        if (active[i] < 0 || active[i] >= n_cells) return nullptr;

    McResult* r = new McResult();
    r->active.assign(active, active + n_active);
    r->lx = lx; r->ly = ly; r->lz = lz;
    r->nx = nx; r->ny = ny; r->nz = nz;
    r->step = step; r->iso = iso;

    r->bm.assign(words, 0);
    uint64_t* bm = r->bm.data();
    for (int64_t i = 0; i < n_active; ++i) {
        const int64_t a = active[i];
        const int64_t cx = a % lx, cy = (a / lx) % ly, cz = a / (lx * ly);
        for (int dz = 0; dz <= 1; ++dz)
            for (int dy = 0; dy <= 1; ++dy)
                for (int dx = 0; dx <= 1; ++dx) {
                    const int64_t pid =
                        ((cz + dz) * py_n + (cy + dy)) * px_n + (cx + dx);
                    bm[pid >> 6] |= 1ull << (pid & 63);
                }
    }
    r->rank.resize(words + 1);
    r->rank[0] = 0;
    for (int64_t w = 0; w < words; ++w)
        r->rank[w + 1] = r->rank[w] + __builtin_popcountll(bm[w]);
    return r;
}

// Per-worker output of the threaded geometry pass: everything welded with
// LOCAL ranks; the sequential merge below assigns global first-occurrence
// ranks. See mc_sparse_geometry for the bit-identity argument.
struct LocalGeo {
    WeldMap weld;
    std::vector<int64_t> keys;       // per local vid: canonical weld key
    std::vector<double> verts;       // per local vid: (x, y, z) index-space
    std::vector<uint8_t> vert_vi;    // per local vid: edge index (12 = center)
    std::vector<int32_t> vert_base;  // per local vid: cell-origin flat grid id
    std::vector<int32_t> stream;     // local vids, reference order
    std::vector<uint8_t> stream_vi;
    std::vector<int32_t> stream_cell;
};

// The per-cell loop over [start, end), welding into a LocalGeo (no shared
// mutable state — safe to run one instance per thread).
static void geo_worker(const McResult* r, int64_t start, int64_t end,
                       LocalGeo* L) {
    const int64_t lx = r->lx, ly = r->ly;
    const int64_t nx = r->nx, ny = r->ny, nz = r->nz;
    const int64_t step = r->step;
    const double iso = r->iso;
    const int64_t px_n = lx + 1, py_n = ly + 1;
    const int64_t* active = r->active.data();
    const uint64_t* bm = r->bm.data();
    const int32_t* rank = r->rank.data();
    const float* pv = r->pvals.data();
    const float iso_f = static_cast<float>(iso);
    const int64_t span = end - start;

    auto pos_of = [&](int64_t pid) -> int64_t {
        const uint64_t word = bm[pid >> 6];
        const uint64_t below = word & ((1ull << (pid & 63)) - 1);
        return rank[pid >> 6] + __builtin_popcountll(below);
    };

    L->weld.init(span + 16);
    L->keys.reserve(span);
    L->verts.reserve(span * 3);
    L->vert_vi.reserve(span);
    L->vert_base.reserve(span);
    L->stream.reserve(span * 6);
    L->stream_vi.reserve(span * 6);
    L->stream_cell.reserve(span * 6);
    int32_t next_rank = 0;

    for (int64_t i = start; i < end; ++i) {
        const int64_t a = active[i];
        const int64_t cx = a % lx, cy = (a / lx) % ly, cz = a / (lx * ly);
        const int64_t gx = cx * step, gy = cy * step, gz = cz * step;

        // Corner values (MC numbering) + case byte, exactly as the device
        // classification computed it (f32 compare against iso).
        double v8[8];
        int case_byte = 0;
        for (int k = 0; k < 8; ++k) {
            const int64_t pid = ((cz + CORNER_DZ[k]) * py_n
                                 + (cy + CORNER_DY[k])) * px_n
                              + (cx + CORNER_DX[k]);
            const float val = pv[pos_of(pid)];
            v8[k] = static_cast<double>(val) - iso;
            if (val > iso_f) case_byte |= 1 << k;
        }
        const int casenum = CASES[case_byte * CASES_S0 + 0];
        const int config = CASES[case_byte * CASES_S0 + 1];
        int nt = 0;
        const int8_t* rows = dispatch_cell(casenum, config, v8, &nt);
        if (rows == nullptr || nt == 0) continue;

        const int32_t base32 =
            static_cast<int32_t>((gx * ny + gy) * nz + gz);
        for (int e = 0; e < 3 * nt; ++e) {
            const int vi = rows[e];
            const int64_t kx = gx + step * KEY_OX[vi];
            const int64_t ky = gy + step * KEY_OY[vi];
            const int64_t kz = gz + step * KEY_OZ[vi];
            const int64_t key =
                ((kz * ny + ky) * nx + kx) * 4 + KEY_J[vi];
            bool fresh = false;
            const int32_t vid =
                L->weld.lookup_or_insert(key, next_rank, &fresh);
            L->stream.push_back(vid);
            L->stream_vi.push_back(static_cast<uint8_t>(vi));
            L->stream_cell.push_back(static_cast<int32_t>(i));
            if (fresh) {
                ++next_rank;
                L->keys.push_back(key);
                L->vert_vi.push_back(static_cast<uint8_t>(vi));
                L->vert_base.push_back(base32);
                if (vi < 12) {
                    const int r1x = EDGESRELX[vi * EDGESRELX_S0 + 0];
                    const int r1y = EDGESRELY[vi * EDGESRELY_S0 + 0];
                    const int r1z = EDGESRELZ[vi * EDGESRELZ_S0 + 0];
                    const int r2x = EDGESRELX[vi * EDGESRELX_S0 + 1];
                    const int r2y = EDGESRELY[vi * EDGESRELY_S0 + 1];
                    const int r2z = EDGESRELZ[vi * EDGESRELZ_S0 + 1];
                    const double va = v8[EDGE_MC1[vi]];
                    const double vb = v8[EDGE_MC2[vi]];
                    const double t1 = 1.0 / (FLT_EPS + std::fabs(va));
                    const double t2 = 1.0 / (FLT_EPS + std::fabs(vb));
                    const double ff = t1 + t2;
                    L->verts.push_back(gx + step * (r1x * t1 + r2x * t2) / ff);
                    L->verts.push_back(gy + step * (r1y * t1 + r2y * t2) / ff);
                    L->verts.push_back(gz + step * (r1z * t1 + r2z * t2) / ff);
                } else {  // center vertex v12
                    double s[8], ff = 0.0, fx = 0.0, fy = 0.0, fz = 0.0;
                    for (int k = 0; k < 8; ++k) {
                        s[k] = 1.0 / (FLT_EPS + std::fabs(v8[k]));
                        ff += s[k];
                        fx += s[k] * CORNER_DX[k];
                        fy += s[k] * CORNER_DY[k];
                        fz += s[k] * CORNER_DZ[k];
                    }
                    L->verts.push_back(gx + step * fx / ff);
                    L->verts.push_back(gy + step * fy / ff);
                    L->verts.push_back(gz + step * fz / ff);
                }
            }
        }
    }
}

// Worker-count override for mc_sparse_geometry: <0 = auto (hardware
// concurrency, direct path below 4), 1 = force the direct rolling-layer
// path, >=2 = force the threaded worker+merge path with that many workers.
// Exposed so the parity suite can exercise BOTH dedup implementations on
// any host (the auto rule would otherwise pick exactly one per machine).
static int g_geo_workers_override = -1;

void mc_set_geo_workers(int n) { g_geo_workers_override = n; }

// The point count the corner index expects (rank over the full bitmap) —
// the caller holds the card's point count to it before the geometry.
int64_t mc_sparse_expected_points(void* handle) {
    McResult* r = static_cast<McResult*>(handle);
    return r->rank[r->bm.size()];
}

// Direct sequential pass over [start, end): welds straight into the global
// structures via EPOCH-STAMPED ROLLING FACE LAYERS — the reference's
// face-layer dedup (Cell.cs:123-143) turned O(1): a vertex's owner slot is
// (owner cell x/y, slot j, z parity), a plain array index, and the packed
// (epoch+1)<<32 | vid entry makes stale layers invalid WITHOUT clearing
// (epoch = owner z layer; active cells arrive in ascending (z, y, x)
// order, so one 2-layer window suffices — and chunk boundaries at
// arbitrary cell indices are fine because the window persists in the
// handle). Replaces the hash weld on this path: ~2M probe chains at 256^3
// were the pass's dominant cost; a slot is one load + one compare.
// Produces EXACTLY the same first-occurrence ranks as the hash (both key
// the same (owner, slot) identity in visit order).
static void geo_direct(McResult* r, int64_t start, int64_t end) {
    const int64_t lx = r->lx, ly = r->ly;
    const int64_t nx = r->nx, ny = r->ny, nz = r->nz;
    const int64_t step = r->step;
    const double iso = r->iso;
    const int64_t px_n = lx + 1, py_n = ly + 1;
    const int64_t* active = r->active.data();
    const uint64_t* bm = r->bm.data();
    const int32_t* rank = r->rank.data();
    const float* pv = r->pvals.data();
    const float iso_f = static_cast<float>(iso);
    const int64_t layer_stride = px_n * py_n * 4;

    auto pos_of = [&](int64_t pid) -> int64_t {
        const uint64_t word = bm[pid >> 6];
        const uint64_t below = word & ((1ull << (pid & 63)) - 1);
        return rank[pid >> 6] + __builtin_popcountll(below);
    };

    if (r->layers.empty()) r->layers.assign(layer_stride * 2, 0);
    int64_t* lay = r->layers.data();
    int32_t next_rank = r->next_rank;

    for (int64_t i = start; i < end; ++i) {
        const int64_t a = active[i];
        const int64_t cx = a % lx, cy = (a / lx) % ly, cz = a / (lx * ly);
        const int64_t gx = cx * step, gy = cy * step, gz = cz * step;

        // Prefetch the NEXT cell's corner-index cache lines: at 512^3 the
        // bitmap+rank+pvals working set is tens of MB and this loop is
        // cache-miss-bound; the next cell's corners are computable now.
        if (i + 1 < end) {
            const int64_t an = active[i + 1];
            const int64_t nxc = an % lx, nyc = (an / lx) % ly,
                          nzc = an / (lx * ly);
            const int64_t pid0 = (nzc * py_n + nyc) * px_n + nxc;
            const int64_t pid4 = ((nzc + 1) * py_n + nyc) * px_n + nxc;
            __builtin_prefetch(&bm[pid0 >> 6]);
            __builtin_prefetch(&rank[pid0 >> 6]);
            __builtin_prefetch(&bm[pid4 >> 6]);
            __builtin_prefetch(&rank[pid4 >> 6]);
        }

        double v8[8];
        int case_byte = 0;
        int64_t ppos[8];
        for (int k = 0; k < 8; ++k) {
            const int64_t pid = ((cz + CORNER_DZ[k]) * py_n
                                 + (cy + CORNER_DY[k])) * px_n
                              + (cx + CORNER_DX[k]);
            ppos[k] = pos_of(pid);
            __builtin_prefetch(&pv[ppos[k]]);
        }
        for (int k = 0; k < 8; ++k) {
            const float val = pv[ppos[k]];
            v8[k] = static_cast<double>(val) - iso;
            if (val > iso_f) case_byte |= 1 << k;
        }
        const int casenum = CASES[case_byte * CASES_S0 + 0];
        const int config = CASES[case_byte * CASES_S0 + 1];
        int nt = 0;
        const int8_t* rows = dispatch_cell(casenum, config, v8, &nt);
        if (rows == nullptr || nt == 0) continue;
        // Gradient normals accumulate INLINE (v8/vg are in registers here;
        // the deferred pass re-fetched corner values per cell with cold
        // caches — 635 ms of the 512^3 budget). Same stream order as the
        // deferred pass, so the accumulation is bit-identical to it.
        float vg[8][3];
        corner_gradients(v8, vg);

        const int32_t base32 =
            static_cast<int32_t>((gx * ny + gy) * nz + gz);
        for (int e = 0; e < 3 * nt; ++e) {
            const int vi = rows[e];
            const int64_t oz = cz + KEY_OZ[vi];
            const int64_t slot =
                (oz & 1) * layer_stride
                + ((cy + KEY_OY[vi]) * px_n + (cx + KEY_OX[vi])) * 4
                + KEY_J[vi];
            const int64_t stamp = (oz + 1) << 32;
            const int64_t entry = lay[slot];
            int32_t vid;
            bool fresh;
            if ((entry & ~0xffffffffll) == stamp) {
                vid = static_cast<int32_t>(entry & 0xffffffffll);
                fresh = false;
            } else {
                vid = next_rank;
                lay[slot] = stamp | static_cast<uint32_t>(vid);
                fresh = true;
            }
            r->stream.push_back(vid);
            r->stream_vi.push_back(static_cast<uint8_t>(vi));
            r->stream_cell.push_back(static_cast<int32_t>(i));
            if (fresh) {
                ++next_rank;
                r->normals.push_back(0.0f);
                r->normals.push_back(0.0f);
                r->normals.push_back(0.0f);
                if (vi < 12) {
                    const int r1x = EDGESRELX[vi * EDGESRELX_S0 + 0];
                    const int r1y = EDGESRELY[vi * EDGESRELY_S0 + 0];
                    const int r1z = EDGESRELZ[vi * EDGESRELZ_S0 + 0];
                    const int r2x = EDGESRELX[vi * EDGESRELX_S0 + 1];
                    const int r2y = EDGESRELY[vi * EDGESRELY_S0 + 1];
                    const int r2z = EDGESRELZ[vi * EDGESRELZ_S0 + 1];
                    const double va = v8[EDGE_MC1[vi]];
                    const double vb = v8[EDGE_MC2[vi]];
                    const double t1 = 1.0 / (FLT_EPS + std::fabs(va));
                    const double t2 = 1.0 / (FLT_EPS + std::fabs(vb));
                    const double ff = t1 + t2;
                    r->verts.push_back(gx + step * (r1x * t1 + r2x * t2) / ff);
                    r->verts.push_back(gy + step * (r1y * t1 + r2y * t2) / ff);
                    r->verts.push_back(gz + step * (r1z * t1 + r2z * t2) / ff);
                    r->edge_vid.push_back(vid);
                    r->edge_base.push_back(base32);
                    r->edge_vi.push_back(static_cast<uint8_t>(vi));
                } else {  // center vertex v12
                    double s[8], ff = 0.0, fx = 0.0, fy = 0.0, fz = 0.0;
                    for (int k = 0; k < 8; ++k) {
                        s[k] = 1.0 / (FLT_EPS + std::fabs(v8[k]));
                        ff += s[k];
                        fx += s[k] * CORNER_DX[k];
                        fy += s[k] * CORNER_DY[k];
                        fz += s[k] * CORNER_DZ[k];
                    }
                    r->verts.push_back(gx + step * fx / ff);
                    r->verts.push_back(gy + step * fy / ff);
                    r->verts.push_back(gz + step * fz / ff);
                    r->center_vid.push_back(vid);
                    r->center_base.push_back(base32);
                }
            }
            float* out = r->normals.data()
                       + static_cast<int64_t>(vid) * 3;
            if (vi < 12) {
                const double va = v8[EDGE_MC1[vi]];
                const double vb = v8[EDGE_MC2[vi]];
                const float t1 =
                    static_cast<float>(1.0 / (FLT_EPS + std::fabs(va)));
                const float t2 =
                    static_cast<float>(1.0 / (FLT_EPS + std::fabs(vb)));
                const float* g1 = vg[EDGE_P1[vi]];
                const float* g2 = vg[EDGE_P2[vi]];
                out[0] += g1[0] * t1 + g2[0] * t2;
                out[1] += g1[1] * t1 + g2[1] * t2;
                out[2] += g1[2] * t1 + g2[2] * t2;
            } else {
                for (int k = 0; k < 8; ++k) {
                    const float sk = static_cast<float>(
                        1.0 / (FLT_EPS + std::fabs(v8[k])));
                    out[0] += sk * vg[k][0];
                    out[1] += sk * vg[k][1];
                    out[2] += sk * vg[k][2];
                }
            }
        }
    }
    r->next_rank = next_rank;
    r->grad_inlined = true;
}

// Phase B: dispatch + weld + interpolation, once the point values are in.
// Returns 1 on success, 0 on host/device index mismatch (caller falls
// back). Chunked: call with [start, end) cell ranges in ascending order
// (welding and vertex ranks persist in the handle across calls, so
// splitting is bit-identical to one pass); pvals may be null after the
// first call. counts out (cumulative): [n_verts, stream_len, n_edge,
// n_center].
//
// THREADED internally: the [start, end) range is split into one contiguous
// sub-range per hardware thread; each worker runs the full per-cell pass
// with a LOCAL weld map (geo_worker above), then a sequential merge assigns
// global ranks. The merge is BIT-IDENTICAL to one sequential pass:
//  - a key's winning vertex is the one from the EARLIEST sub-range that saw
//    it, at that range's first-occurrence cell — exactly the cell the
//    sequential pass would have interpolated it at (identical arithmetic;
//    later ranges' duplicate verts are discarded);
//  - global ranks are assigned walking (range order, local-rank order,
//    winners only), which IS global first-occurrence order, so vertex ids,
//    the triangle stream, and the color-input order all match;
//  - the gradient pass (mc_sparse_grad_finalize) still walks the merged
//    stream sequentially, so normal accumulation order is unchanged.
// Pinned against the numpy oracle in tests/test_torch_marching_cubes.py.
int32_t mc_sparse_geometry(void* handle, const float* pvals,
                           int64_t n_points, int64_t start, int64_t end,
                           int64_t* counts) {
    McResult* r = static_cast<McResult*>(handle);
    const int64_t n_active = static_cast<int64_t>(r->active.size());
    const int64_t words = static_cast<int64_t>(r->bm.size());
    const int32_t* rank = r->rank.data();

    if (end > n_active) end = n_active;
    if (end < start) end = start;
    if (pvals != nullptr) {
        if (rank[words] != n_points) return 0;  // device/host disagree
        r->pvals.assign(pvals, pvals + n_points);
    } else if (r->pvals.empty() && end > start && rank[words] != 0) {
        // A non-empty range with no stored values: a later range was called
        // before the one that handed over the point values (an EMPTY range
        // is fine).
        return 0;
    }

    if (start == 0) {
        r->verts.reserve(n_active * 3);
        r->normals.reserve(n_active * 3);
        r->stream.reserve(n_active * 6);
        r->stream_vi.reserve(n_active * 6);
        r->stream_cell.reserve(n_active * 6);
        r->edge_vid.reserve(n_active);
        r->weld.init(n_active + 16);
        r->next_rank = 0;
    }

    // Partition the range across workers (each sub-range must be big enough
    // to amortize its local weld map; small ranges run single-threaded).
    // On hosts with < 4 hardware threads the "spare" cores are busy running
    // the accelerator runtime — measured on a 2-core host, 2 workers + merge
    // LOSE to the sequential pass — so those take the direct rolling-layer
    // path (geo_direct, which also replaces
    // the hash weld with O(1) layer slots).
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    if (g_geo_workers_override >= 1) hw = g_geo_workers_override;
    if (r->geo_mode == 0)
        r->geo_mode =
            (g_geo_workers_override >= 2 || (g_geo_workers_override < 0
                                             && hw >= 4)) ? 2 : 1;
    const int64_t span = end - start;
    // Inside threaded mode a small chunk still runs the worker+merge path
    // (one worker) — the two modes keep different dedup state, so chunks
    // of one handle must never mix them.
    int64_t n_workers = std::min<int64_t>(
        static_cast<int64_t>(hw), std::max<int64_t>(1, span / 16384));
    if (g_geo_workers_override >= 2 && r->geo_mode == 2)
        n_workers = std::min<int64_t>(
            g_geo_workers_override, std::max<int64_t>(1, span));

    if (r->geo_mode == 1) {
        geo_direct(r, start, end);
        r->n_verts = r->next_rank;
        counts[0] = r->n_verts;
        counts[1] = static_cast<int64_t>(r->stream.size());
        counts[2] = static_cast<int64_t>(r->edge_vid.size());
        counts[3] = static_cast<int64_t>(r->center_vid.size());
        return 1;
    }

    std::vector<LocalGeo> locals(n_workers);
    {
        std::vector<std::thread> threads;
        const int64_t per = (span + n_workers - 1) / n_workers;
        for (int64_t w = 0; w < n_workers; ++w) {
            const int64_t s = start + w * per;
            const int64_t e = std::min(end, s + per);
            if (s >= e) break;
            if (w + 1 == n_workers || s + per >= end) {
                geo_worker(r, s, e, &locals[w]);  // run last on this thread
            } else {
                threads.emplace_back(geo_worker, r, s, e, &locals[w]);
            }
        }
        for (auto& t : threads) t.join();
    }

    // Sequential merge: global first-occurrence ranks + stream rewrite.
    WeldMap& weld = r->weld;
    int32_t next_rank = r->next_rank;
    std::vector<std::vector<int32_t>> remaps(n_workers);
    for (int64_t w = 0; w < n_workers; ++w) {
        LocalGeo& L = locals[w];
        const int64_t nloc = static_cast<int64_t>(L.keys.size());
        remaps[w].resize(nloc);
        for (int64_t lv = 0; lv < nloc; ++lv) {
            bool fresh = false;
            const int32_t vid =
                weld.lookup_or_insert(L.keys[lv], next_rank, &fresh);
            remaps[w][lv] = vid;
            if (!fresh) continue;
            ++next_rank;
            r->verts.push_back(L.verts[lv * 3 + 0]);
            r->verts.push_back(L.verts[lv * 3 + 1]);
            r->verts.push_back(L.verts[lv * 3 + 2]);
            r->normals.push_back(0.0f);
            r->normals.push_back(0.0f);
            r->normals.push_back(0.0f);
            const uint8_t vi = L.vert_vi[lv];
            if (vi < 12) {
                // Color-blend inputs: just (cell base, edge) — the device
                // recomputes endpoints and inverse-|value| weights from its
                // resident value grid, ~2.4x less host->device traffic
                // than shipping i1/i2/w1.
                r->edge_vid.push_back(vid);
                r->edge_base.push_back(L.vert_base[lv]);
                r->edge_vi.push_back(vi);
            } else {
                r->center_vid.push_back(vid);
                r->center_base.push_back(L.vert_base[lv]);
            }
        }
    }
    for (int64_t w = 0; w < n_workers; ++w) {
        LocalGeo& L = locals[w];
        const int32_t* remap = remaps[w].data();
        const int64_t slen = static_cast<int64_t>(L.stream.size());
        for (int64_t e = 0; e < slen; ++e)
            r->stream.push_back(remap[L.stream[e]]);
        r->stream_vi.insert(r->stream_vi.end(), L.stream_vi.begin(),
                            L.stream_vi.end());
        r->stream_cell.insert(r->stream_cell.end(), L.stream_cell.begin(),
                              L.stream_cell.end());
    }

    r->next_rank = next_rank;
    r->n_verts = next_rank;
    counts[0] = r->n_verts;
    counts[1] = static_cast<int64_t>(r->stream.size());
    counts[2] = static_cast<int64_t>(r->edge_vid.size());
    counts[3] = static_cast<int64_t>(r->center_vid.size());
    return 1;
}

// Copy out the device color-blend inputs (call between begin and
// grad_finalize so the color dispatch overlaps the gradient pass).
// Export color-blend inputs for edge vertices [edge_from, n_edge) and
// center vertices [center_from, n_center) — chunked geometry dispatches a
// blend per chunk so the transfers overlap the remaining host work.
void mc_sparse_color_inputs(void* handle, int64_t edge_from,
                            int64_t center_from, int32_t* edge_vid,
                            int32_t* edge_base, uint8_t* edge_vi,
                            int32_t* center_vid, int32_t* center_base) {
    McResult* r = static_cast<McResult*>(handle);
    const int64_t ne = static_cast<int64_t>(r->edge_vid.size()) - edge_from;
    const int64_t nc =
        static_cast<int64_t>(r->center_vid.size()) - center_from;
    std::memcpy(edge_vid, r->edge_vid.data() + edge_from,
                ne * sizeof(int32_t));
    std::memcpy(edge_base, r->edge_base.data() + edge_from,
                ne * sizeof(int32_t));
    std::memcpy(edge_vi, r->edge_vi.data() + edge_from, ne);
    std::memcpy(center_vid, r->center_vid.data() + center_from,
                nc * sizeof(int32_t));
    std::memcpy(center_base, r->center_base.data() + center_from,
                nc * sizeof(int32_t));
}

// Part 2: gradient-normal accumulation over the face-reference stream
// (Cell.cs:272-359 — identical contributions per (cell, edge) pair, stream
// order like native/sparse_phase.cc grad_edges) followed by the finalize
// (negative normalized normals, Cell.cs:97-109; index->world transform,
// MarchingCubes.cs:84-91 — same op order as marching_cubes._finalize_geometry
// so results match the numpy path bit-for-bit in the verts and to float
// rounding in the normals). Outputs f32 (V, 3) world verts + unit normals
// and the i32 (S,) triangle stream.
void mc_sparse_grad_finalize(void* handle, const double* size3,
                             const double* center3, float* verts_out,
                             float* normals_out, int32_t* stream_out) {
    McResult* r = static_cast<McResult*>(handle);
    const int64_t lx = r->lx, ly = r->ly;
    const int64_t px_n = lx + 1, py_n = ly + 1;

    auto pos_of = [&](int64_t pid) -> int64_t {
        const uint64_t word = r->bm[pid >> 6];
        const uint64_t below = word & ((1ull << (pid & 63)) - 1);
        return r->rank[pid >> 6] + __builtin_popcountll(below);
    };

    // --- gradient accumulation (stream is cell-major: recompute v8/vg once
    //     per cell run). Skipped when the direct geometry path already
    //     accumulated inline (bit-identical order; see geo_direct). ---
    const int64_t S = static_cast<int64_t>(r->stream.size());
    double v8[8];
    float vg[8][3];
    int32_t cur_cell = -1;
    for (int64_t e = r->grad_inlined ? S : 0; e < S; ++e) {
        const int32_t ci = r->stream_cell[e];
        if (ci != cur_cell) {
            cur_cell = ci;
            const int64_t a = r->active[ci];
            const int64_t cx = a % lx, cy = (a / lx) % ly, cz = a / (lx * ly);
            for (int k = 0; k < 8; ++k) {
                const int64_t pid = ((cz + CORNER_DZ[k]) * py_n
                                     + (cy + CORNER_DY[k])) * px_n
                                  + (cx + CORNER_DX[k]);
                v8[k] = static_cast<double>(r->pvals[pos_of(pid)]) - r->iso;
            }
            corner_gradients(v8, vg);
        }
        const int vi = r->stream_vi[e];
        float* out = r->normals.data()
                   + static_cast<int64_t>(r->stream[e]) * 3;
        if (vi < 12) {
            const double va = v8[EDGE_MC1[vi]];
            const double vb = v8[EDGE_MC2[vi]];
            const float t1 =
                static_cast<float>(1.0 / (FLT_EPS + std::fabs(va)));
            const float t2 =
                static_cast<float>(1.0 / (FLT_EPS + std::fabs(vb)));
            const float* g1 = vg[EDGE_P1[vi]];
            const float* g2 = vg[EDGE_P2[vi]];
            out[0] += g1[0] * t1 + g2[0] * t2;
            out[1] += g1[1] * t1 + g2[1] * t2;
            out[2] += g1[2] * t1 + g2[2] * t2;
        } else {
            for (int k = 0; k < 8; ++k) {
                const float sk = static_cast<float>(
                    1.0 / (FLT_EPS + std::fabs(v8[k])));
                out[0] += sk * vg[k][0];
                out[1] += sk * vg[k][1];
                out[2] += sk * vg[k][2];
            }
        }
    }

    // --- finalize (same double-precision op order as the numpy path) ---
    const double ns[3] = {static_cast<double>(r->nx) - 1.0,
                          static_cast<double>(r->ny) - 1.0,
                          static_cast<double>(r->nz) - 1.0};
    double scale[3];
    for (int d = 0; d < 3; ++d) scale[d] = size3[d] / ns[d];
    const int64_t V = r->n_verts;
    for (int64_t v = 0; v < V; ++v) {
        double n0 = r->normals[v * 3 + 0];
        double n1 = r->normals[v * 3 + 1];
        double n2 = r->normals[v * 3 + 2];
        double norm = std::sqrt(n0 * n0 + n1 * n1 + n2 * n2);
        double den = norm > 0 ? norm : 1.0;  // divides (not reciprocal
        n0 = -n0 / den; n1 = -n1 / den; n2 = -n2 / den;  // muls): numpy parity
        n0 /= scale[0]; n1 /= scale[1]; n2 /= scale[2];
        norm = std::sqrt(n0 * n0 + n1 * n1 + n2 * n2);
        den = norm > 0 ? norm : 1.0;
        normals_out[v * 3 + 0] = static_cast<float>(n0 / den);
        normals_out[v * 3 + 1] = static_cast<float>(n1 / den);
        normals_out[v * 3 + 2] = static_cast<float>(n2 / den);
        for (int d = 0; d < 3; ++d) {
            const double w = (r->verts[v * 3 + d] - ns[d] / 2.0) * scale[d]
                           + center3[d];
            verts_out[v * 3 + d] = static_cast<float>(w);
        }
    }
    std::memcpy(stream_out, r->stream.data(), S * sizeof(int32_t));
}

void mc_sparse_free(void* handle) {
    delete static_cast<McResult*>(handle);
}

// ---------------------------------------------------------------------------
// Sequential reference-style baseline (see file header). Walks ALL cells of
// the full grid single-threaded: per cell it gathers 8 corner values AND 8
// corner colors (the reference's SetCube signature, MarchingCubes.cs:69-79),
// computes the case byte, dispatches the MC33 switch, dedups vertices via two
// rolling face layers (Cell.cs:123-143), interpolates vertex positions AND
// colors by inverse-|value| weights and accumulates gradient normals
// (Cell.cs:272-359). Output arrays are produced for real (so nothing is
// dead-code-eliminated); the caller times the call and checks the counts.
//   values: (nx, ny, nz) f32, x-major;  colors: (nx, ny, nz, 3) f32 or null
// Returns the vertex count; out_counts[0] = stream length (3 * triangles).
// ---------------------------------------------------------------------------

int64_t mc_sequential_baseline(const float* values, const float* colors,
                               int64_t nx, int64_t ny, int64_t nz,
                               int64_t step, double iso,
                               int64_t* out_counts) {
    const int64_t lx = nx - step > 0 ? (nx - step - 1) / step + 1 : 0;
    const int64_t ly = ny - step > 0 ? (ny - step - 1) / step + 1 : 0;
    const int64_t lz = nz - step > 0 ? (nz - step - 1) / step + 1 : 0;
    if (lx == 0 || ly == 0 || lz == 0) {
        out_counts[0] = 0;
        return 0;
    }

    std::vector<double> verts;
    std::vector<float> vcols;
    std::vector<float> normals;
    std::vector<int32_t> stream;

    // Two rolling face layers of 4 vertex slots per (x, y) cell column
    // (slot 0: x-edge, 1: y-edge, 2: z-edge, 3: center), -1 = undefined.
    const int64_t layer_n = (lx + 1) * (ly + 1) * 4;
    std::vector<int32_t> layer_a(layer_n, -1), layer_b(layer_n, -1);
    int32_t* lay[2] = {layer_a.data(), layer_b.data()};

    const float iso_f = static_cast<float>(iso);
    double v8[8];
    float c8[8][3];
    float vg[8][3];

    for (int64_t cz = 0; cz < lz; ++cz) {
        // New z layer: the "next" layer becomes current, next is cleared
        // (Cell.NewZValue, Cell.cs:123-143).
        if (cz > 0) {
            std::swap(lay[0], lay[1]);
            std::fill(lay[1], lay[1] + layer_n, -1);
        }
        const int64_t gz = cz * step;
        for (int64_t cy = 0; cy < ly; ++cy) {
            const int64_t gy = cy * step;
            for (int64_t cx = 0; cx < lx; ++cx) {
                const int64_t gx = cx * step;
                // SetCube: gather 8 corner values + colors, build case byte.
                int case_byte = 0;
                for (int k = 0; k < 8; ++k) {
                    const int64_t ix = gx + step * CORNER_DX[k];
                    const int64_t iy = gy + step * CORNER_DY[k];
                    const int64_t iz = gz + step * CORNER_DZ[k];
                    const int64_t fi = (ix * ny + iy) * nz + iz;
                    const float val = values[fi];
                    v8[k] = static_cast<double>(val) - iso;
                    if (val > iso_f) case_byte |= 1 << k;
                    if (colors) {
                        c8[k][0] = colors[fi * 3 + 0];
                        c8[k][1] = colors[fi * 3 + 1];
                        c8[k][2] = colors[fi * 3 + 2];
                    }
                }
                const int casenum = CASES[case_byte * CASES_S0 + 0];
                if (casenum == 0) continue;
                const int config = CASES[case_byte * CASES_S0 + 1];
                int nt = 0;
                const int8_t* rows = dispatch_cell(casenum, config, v8, &nt);
                if (!rows || nt == 0) continue;
                corner_gradients(v8, vg);

                for (int e = 0; e < 3 * nt; ++e) {
                    const int vi = rows[e];
                    // Face-layer dedup: owner (cell offset, slot).
                    const int64_t ox = cx + KEY_OX[vi];
                    const int64_t oy = cy + KEY_OY[vi];
                    const int oz = KEY_OZ[vi];
                    int32_t* slot =
                        lay[oz] + (oy * (lx + 1) + ox) * 4 + KEY_J[vi];
                    int32_t vid = *slot;
                    if (vid < 0) {
                        vid = static_cast<int32_t>(verts.size() / 3);
                        *slot = vid;
                        normals.push_back(0.0f);
                        normals.push_back(0.0f);
                        normals.push_back(0.0f);
                        if (vi < 12) {
                            const int r1x = EDGESRELX[vi * 2 + 0];
                            const int r1y = EDGESRELY[vi * 2 + 0];
                            const int r1z = EDGESRELZ[vi * 2 + 0];
                            const int r2x = EDGESRELX[vi * 2 + 1];
                            const int r2y = EDGESRELY[vi * 2 + 1];
                            const int r2z = EDGESRELZ[vi * 2 + 1];
                            const double va = v8[EDGE_MC1[vi]];
                            const double vb = v8[EDGE_MC2[vi]];
                            const double t1 = 1.0 / (FLT_EPS + std::fabs(va));
                            const double t2 = 1.0 / (FLT_EPS + std::fabs(vb));
                            const double ff = t1 + t2;
                            verts.push_back(
                                gx + step * (r1x * t1 + r2x * t2) / ff);
                            verts.push_back(
                                gy + step * (r1y * t1 + r2y * t2) / ff);
                            verts.push_back(
                                gz + step * (r1z * t1 + r2z * t2) / ff);
                            if (colors) {
                                const float w1 =
                                    static_cast<float>(t1 / ff);
                                const int k1 = EDGE_MC1[vi], k2 = EDGE_MC2[vi];
                                for (int d = 0; d < 3; ++d)
                                    vcols.push_back(c8[k1][d] * w1
                                                    + c8[k2][d] * (1.0f - w1));
                            }
                        } else {
                            double s[8], ff = 0, fx = 0, fy = 0, fz = 0;
                            for (int k = 0; k < 8; ++k) {
                                s[k] = 1.0 / (FLT_EPS + std::fabs(v8[k]));
                                ff += s[k];
                                fx += s[k] * CORNER_DX[k];
                                fy += s[k] * CORNER_DY[k];
                                fz += s[k] * CORNER_DZ[k];
                            }
                            verts.push_back(gx + step * fx / ff);
                            verts.push_back(gy + step * fy / ff);
                            verts.push_back(gz + step * fz / ff);
                            if (colors) {
                                float cr = 0, cg = 0, cb = 0;
                                for (int k = 0; k < 8; ++k) {
                                    const float wk =
                                        static_cast<float>(s[k] / ff);
                                    cr += wk * c8[k][0];
                                    cg += wk * c8[k][1];
                                    cb += wk * c8[k][2];
                                }
                                vcols.push_back(cr);
                                vcols.push_back(cg);
                                vcols.push_back(cb);
                            }
                        }
                    }
                    stream.push_back(vid);
                    float* out = normals.data()
                               + static_cast<int64_t>(vid) * 3;
                    if (vi < 12) {
                        const double va = v8[EDGE_MC1[vi]];
                        const double vb = v8[EDGE_MC2[vi]];
                        const float t1 = static_cast<float>(
                            1.0 / (FLT_EPS + std::fabs(va)));
                        const float t2 = static_cast<float>(
                            1.0 / (FLT_EPS + std::fabs(vb)));
                        const float* g1 = vg[EDGE_P1[vi]];
                        const float* g2 = vg[EDGE_P2[vi]];
                        out[0] += g1[0] * t1 + g2[0] * t2;
                        out[1] += g1[1] * t1 + g2[1] * t2;
                        out[2] += g1[2] * t1 + g2[2] * t2;
                    } else {
                        for (int k = 0; k < 8; ++k) {
                            const float sk = static_cast<float>(
                                1.0 / (FLT_EPS + std::fabs(v8[k])));
                            out[0] += sk * vg[k][0];
                            out[1] += sk * vg[k][1];
                            out[2] += sk * vg[k][2];
                        }
                    }
                }
            }
        }
    }
    out_counts[0] = static_cast<int64_t>(stream.size());
    return static_cast<int64_t>(verts.size() / 3);
}

}  // extern "C"
