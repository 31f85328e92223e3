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

// The march from depth0: n-1 distance-only steps. Misses keep accumulating
// depth (to ~1e12 at 40 steps): no early exit, no hit threshold.
//
// WANT_STORE also writes the depth history the backward can take in place of
// its replay (the TPU kernel's want_store output, _march_and_shade): row i of
// `store` (stride floats apart) holds the depth before step i for i in
// 0..n-2, and row n-1 the depth before the final step.
template <bool WANT_STORE = false>
__host__ __device__ __forceinline__ float march_depth(const Ray& r, const float* P,
                                                      const RenderArgs& a,
                                                      float* store = nullptr,
                                                      long long stride = 0) {
  float depth = a.depth0;
  for (int i = 0; i < a.iters - 1; ++i) {
    if (WANT_STORE) store[i * stride] = depth;
    depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
  }
  if (WANT_STORE) store[(a.iters - 1) * stride] = depth;
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
  // Misses shade at a benign depth (the JAX package's backward needs this;
  // the forward keeps the same surface point so both agree).
  const float sd = bg ? a.near_ : depth;
  const float sx = r.ox + r.dx * sd;
  const float sy = r.oy + r.dy * sd;
  const float sz = r.oz + r.dz * sd;
  const float e = 1e-5f;
  float nx = sdf_dist(sx + e, sy, sz, P) - sdf_dist(sx + -e, sy, sz, P);
  float ny = sdf_dist(sx, sy + e, sz, P) - sdf_dist(sx, sy + -e, sz, P);
  float nz = sdf_dist(sx, sy, sz + e, P) - sdf_dist(sx, sy, sz + -e, P);
  safe_normalize(nx, ny, nz);
  float lx = 5.0f - sx;
  float ly = 5.0f - sy;
  float lz = 10.0f - sz;
  safe_normalize(lx, ly, lz);
  const float lambert = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
  if (bg) {
    o[0] = 0.5f;
    o[1] = 0.75f;
    o[2] = 1.0f;
  } else {
    o[0] = cr * lambert + 0.1f;
    o[1] = cg * lambert + 0.1f;
    o[2] = cb * lambert + 0.1f;
  }
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
