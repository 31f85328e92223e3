// Per-pixel pullback of the sphere-trace render: the cotangent of one pixel's
// colour (or depth) becomes that pixel's share of the cotangents of the scene
// parameters and of the 19 view scalars.
//
// Replaces the body of sdfkit_tpu/render/pallas/raymarch_kernel.py
// _pallas_render_image_bwd, one pixel per call where the TPU kernel took a
// 128x128 tile. It computes what that kernel computes:
//   1. replay the march, keeping the pre-step depth of every step (store=None),
//      or read those depths from the forward's depth history (store given);
//   2. the pullback of the final step and the shading (_final_shade);
//   3. a reverse sweep over the kept depths, one single-evaluation pullback
//      per step;
//   4. the pullback of ray generation to inverse(view @ proj) and the camera
//      position.
// The TPU kernel differentiated the traced scene body with jax.vjp; here the
// scene compiler (sdfkit_tpu_torch/sdf/compile.py) emits the adjoints, which
// the including translation unit defines before this file, after the forward
// functions raymarch_fwd.cuh needs:
//
//   #define SDF_N_PARAMS <parameter slots>
//   float sdf_dist_vjp(px, py, pz, P, g, &gpx, &gpy, &gpz, gP);
//   float sdf_eval_vjp(px, py, pz, P, gr, gg, gb, gd, &gpx, &gpy, &gpz, gP);
//
// Each sets the point's cotangent, adds the parameters' to gP[slot] and
// returns the distance. Like raymarch_fwd.cuh this is host-and-device code
// with no CUDA header, so the CPU tests compile it with a host compiler.
#pragma once

#include "raymarch_fwd.cuh"

// The replay's depth history is a per-thread array, so the iteration count,
// a run-time field of RenderArgs, is bounded when the kernel is compiled.
#ifndef SDF_MAX_ITERS
#define SDF_MAX_ITERS 64
#endif

// Loops over the accumulators are unrolled for a small scene, so that every
// index is a constant and the accumulators can live in registers.
constexpr int kSdfNOut = SDF_N_PARAMS + 19;
constexpr int kSdfAccUnroll = kSdfNOut <= 96 ? kSdfNOut : 1;

// Cotangents of one ray: origin and direction.
struct RayGrad {
  float ox, oy, oz, dx, dy, dz;
};

// One step of the march, depth' = depth + d(ro + rd * depth), pulled back:
// adds the step's share to the ray and the parameters, and returns the
// cotangent of `depth`, g * (1 + grad d . rd).
__host__ __device__ __forceinline__ float step_vjp(const Ray& r, float depth, float g,
                                                   const float* P, RayGrad& gr, float* gP) {
  float gx, gy, gz;
  sdf_dist_vjp(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P, g, &gx, &gy,
               &gz, gP);
  gr.ox += gx;
  gr.oy += gy;
  gr.oz += gz;
  gr.dx += gx * depth;
  gr.dy += gy * depth;
  gr.dz += gz * depth;
  return g + (gx * r.dx + gy * r.dy + gz * r.dz);
}

// y = v * rsqrt(max(|v|^2, 1e-30)) pulled back: the cotangent of v from the
// cotangent of y. The floor passes nothing below it (half on a tie).
__host__ __device__ __forceinline__ void safe_normalize_vjp(float vx, float vy, float vz,
                                                            float gyx, float gyy, float gyz,
                                                            float& gvx, float& gvy, float& gvz) {
  const float ssq = vx * vx + vy * vy + vz * vz;
  const float floor_ = 1e-30f;
  const float m = fmaxf(ssq, floor_);
  const float inv = rsqrt_hd(m);
  const float g_inv = gyx * vx + gyy * vy + gyz * vz;
  const float g_m = -0.5f * g_inv * inv / m;
  const float g_ssq = ssq > floor_ ? g_m : (ssq < floor_ ? 0.0f : 0.5f * g_m);
  gvx = gyx * inv + 2.0f * g_ssq * vx;
  gvy = gyy * inv + 2.0f * g_ssq * vy;
  gvz = gyz * inv + 2.0f * g_ssq * vz;
}

// The final colour step and the shading pulled back (the port's forward copy
// is shade_ray in raymarch_fwd.cuh). `g` is the pixel's RGB cotangent and
// `depth` the depth after the n-1 march steps. Returns false for a sky
// pixel, whose colour is a constant: it contributes exactly zero and the
// caller skips its sweep. Otherwise *g_depth is the cotangent of `depth`.
__host__ __device__ __forceinline__ bool final_shade_vjp(const Ray& r, float depth,
                                                         const float* g, const float* P,
                                                         const RenderArgs& a, RayGrad& gr,
                                                         float* gP, float* g_depth) {
  const float px = r.ox + r.dx * depth;
  const float py = r.oy + r.dy * depth;
  const float pz = r.oz + r.dz * depth;
  float cr, cg, cb;
  const float sd = depth + sdf_eval(px, py, pz, P, &cr, &cg, &cb);
  if (sd > a.far_) return false;
  // A hit shades at its own depth (shade_depth = bg ? near : depth).
  const float sx = r.ox + r.dx * sd;
  const float sy = r.oy + r.dy * sd;
  const float sz = r.oz + r.dz * sd;
  const float e = 1e-5f;
  // Taps 0..5 are +x, -x, +y, -y, +z, -z; an untouched axis adds 0.0f, which
  // leaves it bit-identical to the forward's tap.
  float tap[6];
#pragma unroll 1
  for (int t = 0; t < 6; ++t) {
    const float off = (t & 1) ? -e : e;
    const int axis = t >> 1;
    tap[t] = sdf_dist(sx + (axis == 0 ? off : 0.0f), sy + (axis == 1 ? off : 0.0f),
                      sz + (axis == 2 ? off : 0.0f), P);
  }
  const float rx = tap[0] - tap[1];
  const float ry = tap[2] - tap[3];
  const float rz = tap[4] - tap[5];
  float nx = rx, ny = ry, nz = rz;
  safe_normalize(nx, ny, nz);
  const float wx = 5.0f - sx;
  const float wy = 5.0f - sy;
  const float wz = 10.0f - sz;
  float lx = wx, ly = wy, lz = wz;
  safe_normalize(lx, ly, lz);
  const float dotnl = nx * lx + ny * ly + nz * lz;
  const float lambert = fmaxf(dotnl, 0.0f);

  // rgb = diffuse * lambert + ambient.
  const float g_cr = g[0] * lambert;
  const float g_cg = g[1] * lambert;
  const float g_cb = g[2] * lambert;
  const float g_lambert = g[0] * cr + g[1] * cg + g[2] * cb;
  const float g_dot = dotnl > 0.0f ? g_lambert : (dotnl < 0.0f ? 0.0f : 0.5f * g_lambert);
  float g_rx, g_ry, g_rz;  // cotangent of the raw central differences
  safe_normalize_vjp(rx, ry, rz, g_dot * lx, g_dot * ly, g_dot * lz, g_rx, g_ry, g_rz);
  float g_wx, g_wy, g_wz;  // cotangent of light - surface
  safe_normalize_vjp(wx, wy, wz, g_dot * nx, g_dot * ny, g_dot * nz, g_wx, g_wy, g_wz);
  // The taps' cotangents are about 1/(2e-5) times the pixel's and cancel in
  // pairs. They are summed on their own before they join the running sums,
  // so that the cancellation loses nothing to what the sums already hold.
  float g_sx = 0.0f, g_sy = 0.0f, g_sz = 0.0f;  // cotangent of the surface point
  float tapP[SDF_N_PARAMS > 0 ? SDF_N_PARAMS : 1];
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < SDF_N_PARAMS; ++j) tapP[j] = 0.0f;
#pragma unroll 1
  for (int t = 0; t < 6; ++t) {
    const float off = (t & 1) ? -e : e;
    const int axis = t >> 1;
    const float g_axis = axis == 0 ? g_rx : (axis == 1 ? g_ry : g_rz);
    float gx, gy, gz;
    sdf_dist_vjp(sx + (axis == 0 ? off : 0.0f), sy + (axis == 1 ? off : 0.0f),
                 sz + (axis == 2 ? off : 0.0f), P, (t & 1) ? -g_axis : g_axis, &gx, &gy, &gz,
                 tapP);
    g_sx += gx;
    g_sy += gy;
    g_sz += gz;
  }
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < SDF_N_PARAMS; ++j) gP[j] += tapP[j];
  g_sx -= g_wx;
  g_sy -= g_wy;
  g_sz -= g_wz;
  // surface = ro + rd * sd, and sd = depth + dist.
  gr.ox += g_sx;
  gr.oy += g_sy;
  gr.oz += g_sz;
  gr.dx += g_sx * sd;
  gr.dy += g_sy * sd;
  gr.dz += g_sz * sd;
  const float g_sd = g_sx * r.dx + g_sy * r.dy + g_sz * r.dz;
  float gx, gy, gz;
  sdf_eval_vjp(px, py, pz, P, g_cr, g_cg, g_cb, g_sd, &gx, &gy, &gz, gP);
  gr.ox += gx;
  gr.oy += gy;
  gr.oz += gz;
  gr.dx += gx * depth;
  gr.dy += gy * depth;
  gr.dz += gz * depth;
  *g_depth = g_sd + (gx * r.dx + gy * r.dy + gz * r.dz);
  return true;
}

// ray_from_index pulled back: the ray's cotangent becomes that of the 16
// entries of inverse(view @ proj) (row 2 never enters a ray and gets zero)
// and of the camera position, added to gV[0..19).
__host__ __device__ __forceinline__ void ray_vjp(int idx, const float* view19,
                                                 const RenderArgs& a, const Ray& r,
                                                 const RayGrad& gr, float* gV) {
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
  const float qx = hx / hw, qy = hy / hw, qz = hz / hw;
  const float vx = qx - r.ox, vy = qy - r.oy, vz = qz - r.oz;
  const float len = sqrtf(vx * vx + vy * vy + vz * vz);
  // rd = v / |v|.
  const float along = gr.dx * r.dx + gr.dy * r.dy + gr.dz * r.dz;
  const float g_vx = (gr.dx - r.dx * along) / len;
  const float g_vy = (gr.dy - r.dy * along) / len;
  const float g_vz = (gr.dz - r.dz * along) / len;
  // v = h.xyz / h.w - cam, and the camera is the ray origin too.
  gV[16] += gr.ox - g_vx;
  gV[17] += gr.oy - g_vy;
  gV[18] += gr.oz - g_vz;
  const float g_hx = g_vx / hw;
  const float g_hy = g_vy / hw;
  const float g_hz = g_vz / hw;
  const float g_hw = -(g_vx * qx + g_vy * qy + g_vz * qz) / hw;
  gV[0] += xf * g_hx;
  gV[1] += xf * g_hy;
  gV[2] += xf * g_hz;
  gV[3] += xf * g_hw;
  gV[4] += yf * g_hx;
  gV[5] += yf * g_hy;
  gV[6] += yf * g_hz;
  gV[7] += yf * g_hw;
  gV[12] += g_hx;
  gV[13] += g_hy;
  gV[14] += g_hz;
  gV[15] += g_hw;
}

// The pullback of one ray, marched and shaded (shade_ray in raymarch_fwd.cuh).
// `g` is its cotangent (3 floats, or 1 in depth mode). The parameters' share
// is added to gP[0..SDF_N_PARAMS); `gr` is set to the cotangent of the ray's
// origin and direction. Returns false, with `gr` all zero, for a sky ray: it
// contributes exactly nothing and the caller skips what follows.
//
// Without a store the march is replayed first, keeping the pre-step depth of
// every step in a per-thread array, so a.iters must be in [1, SDF_MAX_ITERS]
// (the launcher checks it). HAS_STORE reads those depths from the forward's
// depth history instead (row i at store[i * stride]; row n-1 is the depth
// before the final step): no replay, no array, any iteration count.
template <bool WANT_COLOR, bool HAS_STORE = false>
__host__ __device__ __forceinline__ bool pullback_ray(const Ray& r, const float* P,
                                                      const RenderArgs& a, const float* g,
                                                      float* gP, RayGrad& gr,
                                                      const float* store = nullptr,
                                                      long long stride = 0) {
  gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float history[HAS_STORE ? 1 : SDF_MAX_ITERS];
  float depth;
  if (HAS_STORE) {
    depth = store[(a.iters - 1) * stride];
  } else {
    // Replay the march, keeping each step's pre-step depth.
    depth = a.depth0;
    for (int i = 0; i < a.iters - 1; ++i) {
      history[i] = depth;
      depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
    }
  }
  float g_depth;
  if (WANT_COLOR) {
    if (!final_shade_vjp(r, depth, g, P, a, gr, gP, &g_depth)) return false;
  } else {
    // Depth mode: the last step is one more march step.
    g_depth = step_vjp(r, depth, g[0], P, gr, gP);
  }
  for (int i = a.iters - 2; i >= 0; --i) {
    g_depth = step_vjp(r, HAS_STORE ? store[i * stride] : history[i], g_depth, P, gr, gP);
  }
  return true;
}

// The whole pullback of pixel `idx`: its ray from the index, pullback_ray,
// then ray_vjp. `g` is its cotangent (3 floats, or 1 in depth mode); its
// share is added to gP[0..SDF_N_PARAMS) and gV[0..19). `store` is the
// launch's depth history (HAS_STORE), laid out as shade_pixel writes it.
template <bool WANT_COLOR, bool HAS_STORE = false>
__host__ __device__ __forceinline__ void pullback_pixel(int idx, const float* P,
                                                        const float* view19,
                                                        const RenderArgs& a, const float* g,
                                                        float* gP, float* gV,
                                                        const float* store = nullptr) {
  const Ray r = ray_from_index(idx, view19, a);
  RayGrad gr;
  if (!pullback_ray<WANT_COLOR, HAS_STORE>(r, P, a, g, gP, gr,
                                           HAS_STORE ? store + (idx - a.pix0) : nullptr,
                                           a.local_npix)) {
    return;
  }
  ray_vjp(idx, view19, a, r, gr, gV);
}
