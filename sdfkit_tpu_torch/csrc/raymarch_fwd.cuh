// Per-pixel forward sphere trace: ray generation, the fixed-step march, the
// final colour step, central-difference normal, Lambert shading and sky.
//
// Replaces the bodies of sdfkit_tpu/render/pallas/raymarch_kernel.py
// _pallas_render_image_flat (with _rays_from_scalars, _march_and_shade, its
// want_store depth history, and _final_shade) and _pallas_render_flat (the
// same for rays given as arrays), one ray per call instead of one 256x128
// tile per grid step.
//
// This header holds host-and-device code only and includes no CUDA header, so
// the same per-pixel function also compiles with a host C++ compiler (the CPU
// tests define __host__, __device__ and __forceinline__ away). The
// including translation unit must first define the scene's two functions,
// which sdfkit_tpu_torch/sdf/compile.py emits:
//
//   float sdf_dist(float px, float py, float pz, const float* P);
//   float sdf_eval(float px, float py, float pz, const float* P,
//                  float* r, float* g, float* b);
//
// Only IEEE '/', sqrtf, fmaf, floorf, fminf/fmaxf, cosf/sinf and rsqrtf are
// used.
#pragma once

#ifndef SDF_LARGE
#define SDF_LARGE 0
#endif

#include <string.h>

// March steps in a group; the test for a warp at its bitwise fixed point
// comes after each group (march_depth). Measured on an H100 with SphereRepeat
// at 1920x1080x40, on a frame that is mostly sky (one sphere) and on the
// SphereRepeat rays shuffled (where no warp settles), device ms of the image
// forward / the ray-batch forward: every step and every lane 0.2705 / 0.2635,
// 0.0787 / 0.0711, shuffled 0.2640; groups of 1 0.2527 / 0.2413, 0.0991 / 0.0845,
// 0.2833; of 2 0.2434 / 0.2320, 0.0834 / 0.0729, 0.2707; of 4 0.2367 /
// 0.2279, 0.0762 / 0.0675, 0.2635; of 8 0.2380 / 0.2358, 0.0731 / 0.0644,
// 0.2671. A test after every step of one rolled loop was 0.2303 / 0.2237 but
// 0.0868 / 0.0764 (the compare, vote and branch are much of one sphere's
// step, and nothing settles there) at 38 / 40 registers. Groups of 4: the
// fastest on SphereRepeat that lose on no frame and stay within 1% shuffled,
// at 32 registers and 16 blocks an SM as without the test.
constexpr int kSettleEvery = 4;

struct RenderArgs {
  int width;
  int height;
  int pix0;        // global flat index of the first pixel this launch renders
  int local_npix;  // pixels (or rays) this launch renders (the output holds these)
  int iters;       // march iterations (the reference's 40)
  float depth0;    // near - 0.1
  float near_;
  float far_;
};

// view19: inverse(view @ proj) row-major (16 floats), then the camera
// position (3 floats).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__host__ __device__ __forceinline__ Ray ray_from_index(int idx, const float* view19,
                                                       const RenderArgs& a) {
  const float* m = view19;
  const int py = idx / a.width;
  const int px = idx - py * a.width;
  const int wden = a.width - 1 > 1 ? a.width - 1 : 1;
  const int hden = a.height - 1 > 1 ? a.height - 1 : 1;
  const float xf = -1.0f + (2.0f * (float)px) / (float)wden;
  const float yf = 1.0f - (2.0f * (float)py) / (float)hden;
  const float hx = xf * m[0] + yf * m[4] + m[12];
  const float hy = xf * m[1] + yf * m[5] + m[13];
  const float hz = xf * m[2] + yf * m[6] + m[14];
  const float hw = xf * m[3] + yf * m[7] + m[15];
  Ray r;
  r.ox = view19[16];
  r.oy = view19[17];
  r.oz = view19[18];
  // (pos - ro).normalize(): straight divide by the length, no epsilon.
  const float vx = hx / hw - r.ox;
  const float vy = hy / hw - r.oy;
  const float vz = hz / hw - r.oz;
  const float len = sqrtf(vx * vx + vy * vy + vz * vz);
  r.dx = vx / len;
  r.dy = vy / len;
  r.dz = vz / len;
  return r;
}

// rsqrtf is a device function; the host build takes 1/sqrt.
__host__ __device__ __forceinline__ float rsqrt_hd(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// v * rsqrt(max(|v|^2, 1e-30)): the floor sits under the square root.
__host__ __device__ __forceinline__ void safe_normalize(float& x, float& y, float& z) {
  const float inv = rsqrt_hd(fmaxf(x * x + y * y + z * z, 1e-30f));
  x *= inv;
  y *= inv;
  z *= inv;
}

// The bits of a float. Two depths are the same only if their bits are equal:
// -0.0 == +0.0, yet the two can make points whose zero components differ in
// sign, and a distance may tell those apart.
__host__ __device__ __forceinline__ unsigned float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
#endif
}

// Whether a step from `depth` to `next` left the depth where it was. The step
// is a function of the depth's bits alone, so a depth that one step left bit
// for bit unchanged no later step changes either: the march has reached its
// fixed point and its result is final. A NaN never settles (the card returns
// a canonical NaN and the host propagates the payload, so the bits of a NaN
// would say different things on the two builds).
__host__ __device__ __forceinline__ bool settled(float next, float depth) {
  return float_bits(next) == float_bits(depth) && next == next;
}

// The lanes that march together, and whether all of them settled. On the
// card these are the lanes of the warp that were active when the march began
// (a thread past the launch's pixels has returned, and a vote must not wait
// for it); on the host a ray is a warp of one lane.
__host__ __device__ __forceinline__ unsigned march_lanes() {
#ifdef __CUDA_ARCH__
  return __activemask();
#else
  return 1u;
#endif
}

__host__ __device__ __forceinline__ bool all_settled(unsigned lanes, bool mine) {
#ifdef __CUDA_ARCH__
  return __all_sync(lanes, mine);
#else
  (void)lanes;
  return mine;
#endif
}

// The march from depth0: n-1 distance-only steps. Misses keep accumulating
// depth (to ~1e12 at 40 steps): no hit threshold. The march ends early only
// where that changes no bit: the steps go in groups of kSettleEvery,
// unrolled, and after each group the lanes leave the loop together when the
// group's last step left every lane's depth where it was; the steps that do
// not fill a group follow without a test. The card and the host run the same
// loop (all_settled is the vote).
//
// WANT_STORE also writes the depth history the backward can take in place of
// its replay (the TPU kernel's want_store output, _march_and_shade): row i of
// `store` (stride floats apart) holds the depth before step i for i in
// 0..n-2, and row n-1 the depth before the final step. The rows are written
// by walking a pointer; a march that has settled writes its remaining rows,
// all equal to its depth, with stores alone.
template <bool WANT_STORE = false>
__host__ __device__ __forceinline__ float march_depth(const Ray& r, const float* P,
                                                      const RenderArgs& a,
                                                      float* store = nullptr,
                                                      long long stride = 0) {
  float depth = a.depth0;
  const int steps = a.iters - 1;
  const unsigned lanes = march_lanes();
  int i = 0;
  bool done = false;
  while (i + kSettleEvery <= steps) {
    float before = depth;
#pragma unroll
    for (int k = 0; k < kSettleEvery; ++k) {
      if (WANT_STORE) {
        *store = depth;
        store += stride;
      }
      before = depth;
      depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
    }
    i += kSettleEvery;
    if (all_settled(lanes, settled(depth, before))) {
      done = true;
      break;
    }
  }
  for (; !done && i < steps; ++i) {
    if (WANT_STORE) {
      *store = depth;
      store += stride;
    }
    depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
  }
  // Rows i..n-1: after a settled step every later depth is this one; after
  // the last step, row n-1 alone.
  if (WANT_STORE) {
    for (; i < a.iters; ++i) {
      *store = depth;
      store += stride;
    }
  }
  return depth;
}

// One ray, marched and shaded: `o` takes its 3 floats of RGB or its depth.
// The image kernel makes the ray from the pixel index first; the ray-batch
// kernel (raymarch_rays_fwd.cu, for _pallas_render_flat) reads it.
//
// WANT_HIT (RGB only) also writes *hit: 1 where the ray hit, 0 where its
// colour is the sky's, a constant. The ray-batch backward skips the rays
// marked 0 (raymarch_bwd.cuh tangent_pullback_ray).
template <bool WANT_COLOR, bool WANT_STORE = false, bool WANT_HIT = false>
__host__ __device__ __forceinline__ void shade_ray(const Ray& r, const float* P,
                                                   const RenderArgs& a, float* o,
                                                   float* store = nullptr,
                                                   long long stride = 0,
                                                   unsigned char* hit = nullptr) {
  static_assert(WANT_COLOR || !WANT_HIT, "the hit flag is a colour render's");
  float depth = march_depth<WANT_STORE>(r, P, a, store, stride);
  if (!WANT_COLOR) {
    depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
    o[0] = depth;
    return;
  }
  // The last step: its colour is the diffuse colour.
  float cr, cg, cb;
  depth += sdf_eval(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P,
                    &cr, &cg, &cb);
  const bool bg = depth > a.far_;
  if (WANT_HIT) *hit = bg ? 0 : 1;
  // A sky lane writes the sky's constant and shades nothing: the taps, the
  // normalisations and Lambert only make a colour that the sky replaces. A
  // warp that is all sky skips them all; a mixed warp runs them for its hit
  // lanes as before. Measured with the groups of 4 (device ms, image /
  // ray-batch forward): SphereRepeat 0.2374 / 0.2304 without the skip, 0.2367
  // / 0.2279 with it; the mostly-sky frame 0.0845 / 0.0748 and 0.0762 /
  // 0.0675; the forward with store within 0.0004 ms either way.
  if (bg) {
    o[0] = 0.5f;
    o[1] = 0.75f;
    o[2] = 1.0f;
    return;
  }
  const float sx = r.ox + r.dx * depth;
  const float sy = r.oy + r.dy * depth;
  const float sz = r.oz + r.dz * depth;
  const float e = 1e-5f;
#if SDF_LARGE
  // A scene of the large tier (sdf/compile.py large_tier) takes the taps an
  // axis at a time, as the backward does: six straight-line evaluations of
  // a large scene side by side keep too many values live for the register
  // file. Measured on an H100 at 1920x1080x40 (tools/torch_kernel_probe.py
  // --taps), straight-line / loop: SphereRepeat (14 slots) 0.2364 / 0.2521
  // ms; unions of 4 to 8 spheres (28-56 slots) within 0.5% of each other;
  // 12 spheres (84) 0.6466 / 0.6264; 24 (168) 1.7796 / 1.4399; 100 (700)
  // 34.62 / 11.50, 255 registers and 264 bytes of stack against 39; 200
  // (1,400) 106.02 / 35.90. So the forward takes the loop past the
  // backward's threshold too. The two forms' frames were bit for bit the
  // same on every union, not on SphereRepeat (nvcc contracts its distance
  // another way in the loop).
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) {
    const float ex = axis == 0 ? e : 0.0f, ey = axis == 1 ? e : 0.0f, ez = axis == 2 ? e : 0.0f;
    const float d = sdf_dist(sx + ex, sy + ey, sz + ez, P) - sdf_dist(sx + -ex, sy + -ey, sz + -ez, P);
    nx = axis == 0 ? d : nx;
    ny = axis == 1 ? d : ny;
    nz = axis == 2 ? d : nz;
  }
#else
  float nx = sdf_dist(sx + e, sy, sz, P) - sdf_dist(sx + -e, sy, sz, P);
  float ny = sdf_dist(sx, sy + e, sz, P) - sdf_dist(sx, sy + -e, sz, P);
  float nz = sdf_dist(sx, sy, sz + e, P) - sdf_dist(sx, sy, sz + -e, P);
#endif
  safe_normalize(nx, ny, nz);
  float lx = 5.0f - sx;
  float ly = 5.0f - sy;
  float lz = 10.0f - sz;
  safe_normalize(lx, ly, lz);
  const float lambert = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
  o[0] = cr * lambert + 0.1f;
  o[1] = cg * lambert + 0.1f;
  o[2] = cb * lambert + 0.1f;
}

// Pixel `idx` of the image: its ray from the index, then shade_ray. `out`
// and `store` are the launch's buffers; the pixel's place in them is
// idx - a.pix0, and the store's rows lie a.local_npix floats apart, so a
// warp's 32 writes of one step sit side by side.
template <bool WANT_COLOR, bool WANT_STORE = false>
__host__ __device__ __forceinline__ void shade_pixel(int idx, const float* P,
                                                     const float* view19,
                                                     const RenderArgs& a, float* out,
                                                     float* store = nullptr) {
  const Ray r = ray_from_index(idx, view19, a);
  const long long local = idx - a.pix0;
  shade_ray<WANT_COLOR, WANT_STORE>(r, P, a, out + (WANT_COLOR ? 3 : 1) * local,
                                    WANT_STORE ? store + local : nullptr, a.local_npix);
}
