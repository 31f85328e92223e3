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
//   3. a reverse sweep over the kept depths;
//   4. the pullback of ray generation to inverse(view @ proj) and the camera
//      position.
// The TPU kernel differentiated the traced scene body with jax.vjp; here the
// scene compiler (sdfkit_tpu_torch/sdf/compile.py) emits the adjoints, which
// the including translation unit defines before this file, after the forward
// functions raymarch_fwd.cuh needs:
//
//   #define SDF_N_PARAMS <parameter slots>
//   #define SDF_N_DIST_SLOTS <slots the distance depends on>
//   float sdf_dist_unit(px, py, pz, P, &ux, &uy, &uz, uP);
//   void sdf_dist_unit_add(g, uP, gP);
//   float sdf_eval_vjp(px, py, pz, P, gr, gg, gb, gd, &gpx, &gpy, &gpz, gP);
//
// What costs a pixel most on an H100 is the length of its chain of dependent
// operations when few warps are in flight to hide it (raymarch_bwd.cu has
// the numbers). The sweep of the TPU kernel fed each step's depth cotangent
// into the next step's whole vjp: 39 forward-and-reverse evaluations, one
// after the other. A vjp is linear in its seed, so the sweep here is in unit
// form: per step the gradient of the distance for a cotangent of one
// (sdf_dist_unit), which needs the kept depth alone, and then the recurrence
// in a few multiply-adds, g' = g + g * (u . rd). The 39 unit gradients do not
// depend on each other, so a thread's loads and square roots of one step
// overlap the arithmetic of the last, and what is left of the chain is one
// multiply-add per step. The six normal taps are taken the same way, the two
// of an axis side by side.
//
// The ray-batch backward takes another route (tangent_pullback_ray): the march
// is a scalar recurrence, depth' = depth + d(ro + rd * depth), so the
// derivatives of the depth in the parameters and in the ray can be carried
// forward beside it, one unit gradient per step, and scaled by the cotangent
// of the final depth once the final step is pulled back. One pass, no replay
// and no kept depths, for any number of iterations.
//
// A scene of many parameter slots takes the large-scene tier (SDF_LARGE, set
// by the emitted adjoint; sdf/compile.py large_tier), the last part of this
// file: the same pullback with no per-thread array whose length is a number
// of slots, its cotangents added to a row of sums per warp as they come
// (raymarch_sums.cuh).
//
// Like raymarch_fwd.cuh this is host-and-device code with no CUDA header, so
// the CPU tests compile it with a host compiler.
#pragma once

#include "raymarch_fwd.cuh"

#ifndef SDF_LARGE
#define SDF_LARGE 0
#endif

// The replay keeps the depths of one segment of the march in a per-thread
// array. A march of more steps is swept segment by segment from its end, each
// segment after a replay from the start that keeps that segment's depths: no
// limit on the iterations, and up to 65 of them cost one replay.
constexpr int kSdfHistory = 64;

// Loops over the accumulators are unrolled for a small scene, so that every
// index is a constant and the accumulators can live in registers.
constexpr int kSdfNOut = SDF_N_PARAMS + 19;
constexpr int kSdfAccUnroll = kSdfNOut <= 96 ? kSdfNOut : 1;
constexpr int kSdfNSlots = SDF_N_DIST_SLOTS > 0 ? SDF_N_DIST_SLOTS : 1;
constexpr int kSdfSlotUnroll = kSdfNSlots <= 96 ? kSdfNSlots : 1;

// Cotangents of one ray: origin and direction.
struct RayGrad {
  float ox, oy, oz, dx, dy, dz;
};

#if !SDF_LARGE
// One step of the march, depth' = depth + d(ro + rd * depth), pulled back
// with the cotangent `g` of depth': adds the step's share to the ray and the
// parameters, and returns the cotangent of `depth`, g + g * (grad d . rd).
// Everything but the last multiply-adds is independent of `g`.
__host__ __device__ __forceinline__ float step_vjp(const Ray& r, float depth, float g,
                                                   const float* P, RayGrad& gr, float* gP) {
  float ux, uy, uz, uP[kSdfNSlots];
  sdf_dist_unit(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P, &ux, &uy,
                &uz, uP);
  const float along = ux * r.dx + uy * r.dy + uz * r.dz;
  const float vx = ux * depth, vy = uy * depth, vz = uz * depth;
  sdf_dist_unit_add(g, uP, gP);
  gr.ox += g * ux;
  gr.oy += g * uy;
  gr.oz += g * uz;
  gr.dx += g * vx;
  gr.dy += g * vy;
  gr.dz += g * vz;
  return g + g * along;
}

// The sweep over `count` kept depths (depths[i * stride], the last first),
// from the cotangent `g` of the depth after them to that of the depth before.
// The steps run one at a time: their unit gradients share no value, so an
// unrolled loop lets the compiler interleave them, but on an H100 that bought
// nothing over the warps already in flight (by two: 0-2% slower, by three:
// 12-20% slower, with more registers spilled).
__host__ __device__ __forceinline__ float sweep_vjp(const Ray& r, const float* depths,
                                                    long long stride, int count, float g,
                                                    const float* P, RayGrad& gr, float* gP) {
#pragma unroll 1
  for (int i = count - 1; i >= 0; --i) g = step_vjp(r, depths[i * stride], g, P, gr, gP);
  return g;
}

#endif  // !SDF_LARGE

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

struct NoHook {
  __host__ __device__ void operator()() const {}
};

#if !SDF_LARGE
// The final colour step and the shading pulled back (the port's forward copy
// is shade_ray in raymarch_fwd.cuh). `g` is the pixel's RGB cotangent and
// `depth` the depth after the n-1 march steps. Returns false for a sky
// pixel, whose colour is a constant: it contributes exactly zero and the
// caller skips its sweep. Otherwise *g_depth is the cotangent of `depth`.
// `on_hit()` runs as soon as the pixel is known to hit, before the taps: a
// caller that has copies to start for the sweep starts them there.
template <class OnHit = NoHook>
__host__ __device__ __forceinline__ bool final_shade_vjp(const Ray& r, float depth,
                                                         const float* g, const float* P,
                                                         const RenderArgs& a, RayGrad& gr,
                                                         float* gP, float* g_depth,
                                                         OnHit on_hit = OnHit()) {
  const float px = r.ox + r.dx * depth;
  const float py = r.oy + r.dy * depth;
  const float pz = r.oz + r.dz * depth;
  float cr, cg, cb;
  const float sd = depth + sdf_eval(px, py, pz, P, &cr, &cg, &cb);
  if (sd > a.far_) return false;
  on_hit();
  // A hit shades at its own depth (shade_depth = bg ? near : depth).
  const float sx = r.ox + r.dx * sd;
  const float sy = r.oy + r.dy * sd;
  const float sz = r.oz + r.dz * sd;
  const float e = 1e-5f;
  // The taps of one axis are at +e and -e; an untouched axis adds 0.0f, which
  // leaves it bit-identical to the forward's tap. The two of a pair share no
  // value, so they run side by side.
  float rx = 0.0f, ry = 0.0f, rz = 0.0f;  // the raw central differences
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) {
    const float ex = axis == 0 ? e : 0.0f, ey = axis == 1 ? e : 0.0f, ez = axis == 2 ? e : 0.0f;
    const float d = sdf_dist(sx + ex, sy + ey, sz + ez, P) - sdf_dist(sx + -ex, sy + -ey, sz + -ez, P);
    rx = axis == 0 ? d : rx;
    ry = axis == 1 ? d : ry;
    rz = axis == 2 ? d : rz;
  }
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
  // pairs. Each pair's unit gradients are subtracted first and the difference
  // scaled by the axis' cotangent, and the three axes are summed on their own
  // before they join the running sums, so that the cancellation loses
  // nothing to the size of the cotangent or to what the sums already hold.
  float g_sx = 0.0f, g_sy = 0.0f, g_sz = 0.0f;  // cotangent of the surface point
  float tapP[kSdfNSlots];
#pragma unroll
  for (int k = 0; k < kSdfNSlots; ++k) tapP[k] = 0.0f;
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) {
    const float ex = axis == 0 ? e : 0.0f, ey = axis == 1 ? e : 0.0f, ez = axis == 2 ? e : 0.0f;
    const float g_axis = axis == 0 ? g_rx : (axis == 1 ? g_ry : g_rz);
    float ax, ay, az, aP[kSdfNSlots], bx, by, bz, bP[kSdfNSlots];
    sdf_dist_unit(sx + ex, sy + ey, sz + ez, P, &ax, &ay, &az, aP);
    sdf_dist_unit(sx + -ex, sy + -ey, sz + -ez, P, &bx, &by, &bz, bP);
    g_sx += g_axis * (ax - bx);
    g_sy += g_axis * (ay - by);
    g_sz += g_axis * (az - bz);
#pragma unroll
    for (int k = 0; k < SDF_N_DIST_SLOTS; ++k) tapP[k] += g_axis * (aP[k] - bP[k]);
  }
  sdf_dist_unit_add(1.0f, tapP, gP);
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

#endif  // !SDF_LARGE

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

// The march from depth0 through steps [0, end), keeping the pre-step depths
// of the steps from `first` on in history[0..end - first). Returns the depth
// after step end - 1.
__host__ __device__ __forceinline__ float replay_march(const Ray& r, const float* P, float depth0,
                                                       int first, int end, float* history) {
  float depth = depth0;
  for (int i = 0; i < end; ++i) {
    if (i >= first) history[i - first] = depth;
    depth += sdf_dist(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P);
  }
  return depth;
}

// Where a pullback finds the depths its sweep needs. ReplayRows: nowhere, the
// pullback replays the march. StoreRows: in the forward's depth history, read
// where it lies (row i of the pixel at at[i * stride]; row n-1 is the depth
// before the final step). A kernel may bring its own source with the members
// of StoreRows (raymarch_bwd.cu stages the rows in shared memory).
struct ReplayRows {
  static constexpr bool kStored = false;
};

struct StoreRows {
  static constexpr bool kStored = true;
  const float* at;
  long long stride;
  // The depth before the final step (row `steps`).
  __host__ __device__ float last(int steps) const { return at[steps * stride]; }
  // The pixel hits and will sweep rows [0, steps): nothing to start here.
  __host__ __device__ void on_hit(int steps) const {}
#if !SDF_LARGE
  // The sweep over rows [0, steps), the last first, from the cotangent g of
  // the depth after them.
  __host__ __device__ float sweep(const Ray& r, int steps, float g, const float* P, RayGrad& gr,
                                  float* gP) const {
    return sweep_vjp(r, at, stride, steps, g, P, gr, gP);
  }
#else
  __host__ __device__ float sweep(const Ray& r, int steps, float g, float u, float depth0,
                                  const float* P, RayGrad& gr, float* gP) const;
#endif
};

#if !SDF_LARGE

// The pullback of one ray, marched and shaded (shade_ray in raymarch_fwd.cuh).
// `g` is its cotangent (3 floats, or 1 in depth mode). The parameters' share
// is added to gP[0..SDF_N_PARAMS); `gr` is set to the cotangent of the ray's
// origin and direction. Returns false, with `gr` all zero, for a sky ray: it
// contributes exactly nothing and the caller skips what follows.
//
// With ReplayRows the march is replayed first, keeping the pre-step depths of
// its last segment of at most kSdfHistory steps; each earlier segment is
// replayed from the start when the sweep reaches it. A stored source gives
// the depths instead: no replay and no array.
template <bool WANT_COLOR, class Rows = ReplayRows>
__host__ __device__ __forceinline__ bool pullback_ray(const Ray& r, const float* P,
                                                      const RenderArgs& a, const float* g,
                                                      float* gP, RayGrad& gr,
                                                      Rows rows = Rows()) {
  gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int steps = a.iters - 1;  // march steps before the final one
  if constexpr (Rows::kStored) {
    const float depth = rows.last(steps);
    float g_depth;
    if (WANT_COLOR) {
      if (!final_shade_vjp(r, depth, g, P, a, gr, gP, &g_depth, [&] { rows.on_hit(steps); })) {
        return false;
      }
    } else {
      // Depth mode: the last step is one more march step.
      rows.on_hit(steps);
      g_depth = step_vjp(r, depth, g[0], P, gr, gP);
    }
    rows.sweep(r, steps, g_depth, P, gr, gP);
    return true;
  } else {
    float history[kSdfHistory];
    int first = steps <= 0 ? 0 : (steps - 1) / kSdfHistory * kSdfHistory;
    const float depth = replay_march(r, P, a.depth0, first, steps, history);
    float g_depth;
    if (WANT_COLOR) {
      if (!final_shade_vjp(r, depth, g, P, a, gr, gP, &g_depth)) return false;
    } else {
      // Depth mode: the last step is one more march step.
      g_depth = step_vjp(r, depth, g[0], P, gr, gP);
    }
    g_depth = sweep_vjp(r, history, 1, steps - first, g_depth, P, gr, gP);
    while (first > 0) {
      first -= kSdfHistory;
      replay_march(r, P, a.depth0, first, first + kSdfHistory, history);
      g_depth = sweep_vjp(r, history, 1, kSdfHistory, g_depth, P, gr, gP);
    }
    return true;
  }
}

// The whole pullback of pixel `idx`: its ray from the index, pullback_ray,
// then ray_vjp. `g` is its cotangent (3 floats, or 1 in depth mode); its
// share is added to gP[0..SDF_N_PARAMS) and gV[0..19). `rows` says where its
// depths come from (a stored source holds the pixel's own column, as
// shade_pixel writes the store). Returns false for a sky pixel, which added
// nothing.
template <bool WANT_COLOR, class Rows = ReplayRows>
__host__ __device__ __forceinline__ bool pullback_pixel(int idx, const float* P,
                                                        const float* view19,
                                                        const RenderArgs& a, const float* g,
                                                        float* gP, float* gV,
                                                        Rows rows = Rows()) {
  const Ray r = ray_from_index(idx, view19, a);
  RayGrad gr;
  if (!pullback_ray<WANT_COLOR>(r, P, a, g, gP, gr, rows)) return false;
  ray_vjp(idx, view19, a, r, gr, gV);
  return true;
}

// The pullback of one ray by a tangent march (the ray-batch backward). With
// t' = t + d(ro + rd * t) and u the gradient of d at the step's point (in the
// point, u_p, and in the parameters the distance reads, u_P), the step's
// factor is s = 1 + u_p . rd and
//   dt'/dP = s dt/dP + u_P,  dt'/dro = s dt/dro + u_p,  dt'/drd = s dt/drd + t u_p,
// from zero at depth0. After the march, the final step and the shading are
// pulled back (final_shade_vjp: their own shares, and the cotangent g_depth
// of the depth they start from; in depth mode g_depth is the cotangent
// itself), and the march's share is g_depth times the three derivatives. The
// sum has the terms of pullback_ray's sweep, associated the other way, and
// each step's unit gradient and distance come from one sdf_dist_unit: one
// evaluation of the scene and its gradient per step, where the replay and
// the sweep took two.
//
// `g` is the ray's cotangent (3 floats, or 1 in depth mode); the parameters'
// share is added to gP[0..SDF_N_PARAMS) and `gr` is set to the cotangent of
// the ray. `depth` is set to the depth the march reached (before the final
// step in RGB, after all n steps in depth mode). Returns false, with `gr` all
// zero and nothing added, for a sky ray; it has marched all the same, so a
// caller that knows the ray missed (the forward's hit flag) skips the call.
template <bool WANT_COLOR>
__host__ __device__ __forceinline__ bool tangent_pullback_ray(const Ray& r, const float* P,
                                                              const RenderArgs& a,
                                                              const float* g, float* gP,
                                                              RayGrad& gr, float& depth) {
  gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float jP[kSdfNSlots];
#pragma unroll kSdfSlotUnroll
  for (int k = 0; k < kSdfNSlots; ++k) jP[k] = 0.0f;
  float jox = 0.0f, joy = 0.0f, joz = 0.0f, jdx = 0.0f, jdy = 0.0f, jdz = 0.0f;
  float t = a.depth0;
  const int steps = WANT_COLOR ? a.iters - 1 : a.iters;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    float ux, uy, uz, uP[kSdfNSlots];
    const float d = sdf_dist_unit(r.ox + r.dx * t, r.oy + r.dy * t, r.oz + r.dz * t, P, &ux,
                                  &uy, &uz, uP);
    const float s = 1.0f + (ux * r.dx + uy * r.dy + uz * r.dz);
#pragma unroll kSdfSlotUnroll
    for (int k = 0; k < SDF_N_DIST_SLOTS; ++k) jP[k] = jP[k] * s + uP[k];
    jox = jox * s + ux;
    joy = joy * s + uy;
    joz = joz * s + uz;
    jdx = jdx * s + t * ux;
    jdy = jdy * s + t * uy;
    jdz = jdz * s + t * uz;
    t += d;
  }
  depth = t;
  float g_depth;
  if (WANT_COLOR) {
    if (!final_shade_vjp(r, t, g, P, a, gr, gP, &g_depth)) return false;
  } else {
    g_depth = g[0];
  }
  sdf_dist_unit_add(g_depth, jP, gP);
  gr.ox += g_depth * jox;
  gr.oy += g_depth * joy;
  gr.oz += g_depth * joz;
  gr.dx += g_depth * jdx;
  gr.dy += g_depth * jdy;
  gr.dz += g_depth * jdz;
  return true;
}
#endif  // !SDF_LARGE

#if SDF_LARGE
// ---------------------------------------------------------------------------
// The large-scene tier: the pullback above, with every parameter cotangent
// added to the row gP as soon as it is known (raymarch_sums.cuh; on the card
// the row of the thread's warp, on the host the thread's own sums) and no
// per-thread array whose length is a number of slots. The emitted adjoints
// (sdf/compile.py emit_large_vjp_cpp) are
//
//   float sdf_dist_vjp(px, py, pz, P, u, g, &ux, &uy, &uz, gP);
//   void sdf_dist_vjp_pair(pa..., pb..., P, u, g, &ua..., &ub..., gP);
//   float sdf_eval_vjp(px, py, pz, P, gr, gg, gb, gd, &gpx, &gpy, &gpz, gP);
//
// The distance's adjoints keep the unit form for the point: u = 1 gives the
// distance's gradient in the point, which the recurrence needs, whatever the
// step's cotangent g, and g scales only what they add to gP. A pair of normal
// taps is pulled back in one call that subtracts the two unit gradients of a
// slot before it scales them, as the small tier subtracts its arrays.
//
// A warp's lanes stay on one path, since each add is the warp's (sdf_acc): a
// pixel that needs no pullback (past the frame's end, or sky) goes along
// with u = 0 and zero cotangents at a point near the camera, where every
// value is finite, so that it adds exactly nothing; a warp in which no lane
// needs one skips the rest. On the host the "warp" is one thread, and the
// pullback of a pixel that needs none ends where the small tier's does.

// One march step pulled back, as step_vjp: `u` is 1 for a lane that takes
// part and 0 for one that goes along (with g = 0). `dist` takes the step's
// distance.
__host__ __device__ __forceinline__ float step_vjp_large(const Ray& r, float depth, float g,
                                                         float u, const float* P, RayGrad& gr,
                                                         float* gP, float* dist) {
  float ux, uy, uz;
  *dist = sdf_dist_vjp(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P, u, g,
                       &ux, &uy, &uz, gP);
  const float along = ux * r.dx + uy * r.dy + uz * r.dz;
  gr.ox += g * ux;
  gr.oy += g * uy;
  gr.oz += g * uz;
  gr.dx += g * (ux * depth);
  gr.dy += g * (uy * depth);
  gr.dz += g * (uz * depth);
  return g + g * along;
}

// The sweep over `count` kept depths (depths[i * stride], the last first); a
// lane that goes along (u = 0) steps at depth0 instead.
__host__ __device__ __forceinline__ float sweep_vjp_large(const Ray& r, const float* depths,
                                                          long long stride, int count, float g,
                                                          float u, float depth0, const float* P,
                                                          RayGrad& gr, float* gP) {
  float d;
#pragma unroll 1
  for (int i = count - 1; i >= 0; --i) {
    g = step_vjp_large(r, u != 0.0f ? depths[i * stride] : depth0, g, u, P, gr, gP, &d);
  }
  return g;
}

__host__ __device__ inline float StoreRows::sweep(const Ray& r, int steps, float g, float u,
                                                  float depth0, const float* P, RayGrad& gr,
                                                  float* gP) const {
  return sweep_vjp_large(r, at, stride, steps, g, u, depth0, P, gr, gP);
}

// final_shade_vjp for the large tier. `active`: the pixel takes part. Sets
// *live to whether it hits (and takes part), and returns whether any lane of
// the warp does: if none does, nothing was added and the caller skips what
// follows; otherwise *g_depth is the cotangent of `depth` (zero where not
// live). `on_hit()` runs on every lane of a warp that goes on.
template <class OnHit = NoHook>
__host__ __device__ __forceinline__ bool final_shade_vjp_large(const Ray& r, float depth,
                                                               bool active, const float* g,
                                                               const float* P,
                                                               const RenderArgs& a, RayGrad& gr,
                                                               float* gP, float* g_depth,
                                                               bool* live,
                                                               OnHit on_hit = OnHit()) {
  float cr, cg, cb;
  float sd = depth + sdf_eval(r.ox + r.dx * depth, r.oy + r.dy * depth, r.oz + r.dz * depth, P,
                              &cr, &cg, &cb);
  *live = active && !(sd > a.far_);
  if (!sdf_any(*live)) return false;
  on_hit();
  const bool on = *live;
  if (!on) {
    depth = a.depth0;  // a finite place to go along
    sd = a.depth0;
  }
  const float u = on ? 1.0f : 0.0f;
  const float g0 = on ? g[0] : 0.0f, g1 = on ? g[1] : 0.0f, g2 = on ? g[2] : 0.0f;
  const float px = r.ox + r.dx * depth;
  const float py = r.oy + r.dy * depth;
  const float pz = r.oz + r.dz * depth;
  const float sx = r.ox + r.dx * sd;
  const float sy = r.oy + r.dy * sd;
  const float sz = r.oz + r.dz * sd;
  const float e = 1e-5f;
  float rx = 0.0f, ry = 0.0f, rz = 0.0f;
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) {
    const float ex = axis == 0 ? e : 0.0f, ey = axis == 1 ? e : 0.0f, ez = axis == 2 ? e : 0.0f;
    const float d = sdf_dist(sx + ex, sy + ey, sz + ez, P) - sdf_dist(sx + -ex, sy + -ey, sz + -ez, P);
    rx = axis == 0 ? d : rx;
    ry = axis == 1 ? d : ry;
    rz = axis == 2 ? d : rz;
  }
  float nx = rx, ny = ry, nz = rz;
  safe_normalize(nx, ny, nz);
  const float wx = 5.0f - sx;
  const float wy = 5.0f - sy;
  const float wz = 10.0f - sz;
  float lx = wx, ly = wy, lz = wz;
  safe_normalize(lx, ly, lz);
  const float dotnl = nx * lx + ny * ly + nz * lz;
  const float lambert = fmaxf(dotnl, 0.0f);
  const float g_cr = g0 * lambert;
  const float g_cg = g1 * lambert;
  const float g_cb = g2 * lambert;
  const float g_lambert = on ? g0 * cr + g1 * cg + g2 * cb : 0.0f;
  const float g_dot = dotnl > 0.0f ? g_lambert : (dotnl < 0.0f ? 0.0f : 0.5f * g_lambert);
  float g_rx, g_ry, g_rz;
  safe_normalize_vjp(rx, ry, rz, g_dot * lx, g_dot * ly, g_dot * lz, g_rx, g_ry, g_rz);
  float g_wx, g_wy, g_wz;
  safe_normalize_vjp(wx, wy, wz, g_dot * nx, g_dot * ny, g_dot * nz, g_wx, g_wy, g_wz);
  float g_sx = 0.0f, g_sy = 0.0f, g_sz = 0.0f;
#pragma unroll 1
  for (int axis = 0; axis < 3; ++axis) {
    const float ex = axis == 0 ? e : 0.0f, ey = axis == 1 ? e : 0.0f, ez = axis == 2 ? e : 0.0f;
    const float g_axis = axis == 0 ? g_rx : (axis == 1 ? g_ry : g_rz);
    float ax, ay, az, bx, by, bz;
    sdf_dist_vjp_pair(sx + ex, sy + ey, sz + ez, sx + -ex, sy + -ey, sz + -ez, P, u, g_axis, &ax,
                      &ay, &az, &bx, &by, &bz, gP);
    g_sx += g_axis * (ax - bx);
    g_sy += g_axis * (ay - by);
    g_sz += g_axis * (az - bz);
  }
  g_sx -= g_wx;
  g_sy -= g_wy;
  g_sz -= g_wz;
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

// pullback_ray for the large tier: `active` says whether the ray takes part.
// Returns whether it hit and was pulled back (`gr` is zero otherwise).
// `reached`, where given, takes the depth the march reached (before the
// final step in RGB, after all n steps in depth mode).
template <bool WANT_COLOR, class Rows = ReplayRows>
__host__ __device__ __forceinline__ bool pullback_ray_large(const Ray& r, bool active,
                                                            const float* P, const RenderArgs& a,
                                                            const float* g, float* gP,
                                                            RayGrad& gr, Rows rows = Rows(),
                                                            float* reached = nullptr) {
  gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int steps = a.iters - 1;  // march steps before the final one
  float history[Rows::kStored ? 1 : kSdfHistory];
  int first = 0;
  float depth;
  if constexpr (Rows::kStored) {
    depth = rows.last(steps);
  } else {
    first = steps <= 0 ? 0 : (steps - 1) / kSdfHistory * kSdfHistory;
    depth = replay_march(r, P, a.depth0, first, steps, history);
  }
  if (reached != nullptr) *reached = depth;
  bool live;
  float g_depth;
  if (WANT_COLOR) {
    if constexpr (Rows::kStored) {
      if (!final_shade_vjp_large(r, depth, active, g, P, a, gr, gP, &g_depth, &live,
                                 [&] { rows.on_hit(steps); })) {
        return false;
      }
    } else if (!final_shade_vjp_large(r, depth, active, g, P, a, gr, gP, &g_depth, &live)) {
      return false;
    }
  } else {
    // Depth mode: the last step is one more march step, for every pixel.
    live = active;
    if (!sdf_any(live)) return false;
    if constexpr (Rows::kStored) rows.on_hit(steps);
    float d;
    g_depth = step_vjp_large(r, live ? depth : a.depth0, live ? g[0] : 0.0f, live ? 1.0f : 0.0f,
                             P, gr, gP, &d);
    if (reached != nullptr) *reached = depth + d;
  }
  const float u = live ? 1.0f : 0.0f;
  if constexpr (Rows::kStored) {
    rows.sweep(r, steps, g_depth, u, a.depth0, P, gr, gP);
  } else {
    g_depth = sweep_vjp_large(r, history, 1, steps - first, g_depth, u, a.depth0, P, gr, gP);
    while (first > 0) {
      first -= kSdfHistory;
      replay_march(r, P, a.depth0, first, first + kSdfHistory, history);
      g_depth = sweep_vjp_large(r, history, 1, kSdfHistory, g_depth, u, a.depth0, P, gr, gP);
    }
  }
  return live;
}

// pullback_pixel for the large tier: `active` says whether pixel `idx` takes
// part; the view's share of a pixel that hit is added to gV.
template <bool WANT_COLOR, class Rows = ReplayRows>
__host__ __device__ __forceinline__ bool pullback_pixel_large(int idx, bool active, const float* P,
                                                              const float* view19,
                                                              const RenderArgs& a, const float* g,
                                                              float* gP, float* gV,
                                                              Rows rows = Rows()) {
  const Ray r = ray_from_index(idx, view19, a);
  RayGrad gr;
  const bool live = pullback_ray_large<WANT_COLOR>(r, active, P, a, g, gP, gr, rows);
  if (live) ray_vjp(idx, view19, a, r, gr, gV);
  return live;
}
#endif  // SDF_LARGE
