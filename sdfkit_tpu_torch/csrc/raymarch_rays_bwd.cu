// The ray-batch pullback kernels for Hopper (sm_90a): the cotangent of every
// ray, and the parameters' cotangents summed over all rays.
//
// The backward of what raymarch_rays_fwd.cu computes. In the JAX package this
// path (sdfkit_tpu/render/pallas/raymarch_kernel.py _render_fused_impl,
// _fused_bwd) has no TPU kernel of its own: its backward is jax.vjp of the
// plain path. Here it is a tangent march (raymarch_bwd.cuh
// tangent_pullback_ray): one pass along the ray that carries the derivatives
// of the depth beside the depth, then the pullback of the final shade, with
// no replay of the march and no kept depths, so any number of iterations
// takes one pass. The ray's own cotangent is an output; there is no ray
// generation to pull back.
//
// What bounds it on the card: the instructions it issues. Per ray it reads
// 24 bytes of ray, 12 (RGB) or 4 (depth) of cotangent and the forward's hit
// flag, and writes 24 bytes of ray cotangent, each array contiguous; its work
// is one evaluation of the scene and its gradient per march step, then the
// final step and six taps. Measured on an H100 with SphereRepeat at
// 1920x1080x40: the image pullback that this kernel ran before replayed the
// march (93.5 instructions a step) and then swept it (229 a step, which
// evaluate the scene again), 14.4k instructions in its loops per hit ray and
// 1.33 ms; the tangent march takes 232 a step, 10.9k per hit ray, and 1.05
// ms, issuing 0.63 of what the card can. The derivatives add
// SDF_N_DIST_SLOTS + 6 floats that stay live across the march. A sky ray has
// a constant colour: with the forward's hit flag it costs one byte read;
// without it, it marches with a gradient at every step and finds the sky at
// the end (on a frame that is mostly sky, 0.09 ms with the flags and 0.18
// without; the replay took 0.13).
//
// The parameters' cotangents are summed over a grid-stride loop in per-thread
// accumulators, then raymarch_reduce.cuh (one full wave of blocks; no
// atomics, so two launches give bit-identical sums).
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval, SDF_N_PARAMS and the adjoints
// sdf_dist_unit/sdf_eval_vjp, and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_bwd.cuh"
#include "raymarch_reduce.cuh"
#include "raymarch_uniforms.cuh"

constexpr int kNParams = SDF_N_PARAMS;
constexpr int kNAcc = kNParams > 0 ? kNParams : 1;
// Resident blocks per SM that the register allocation aims at. Measured on
// an H100 with SphereRepeat at 1920x1080x40: 4 blocks (127 registers, no
// spill) 1.088 ms, 5 (96, 192 bytes spilled) 1.054, 6 (80, 284 bytes) 1.069.
constexpr int kRaysBwdMinBlocks = 5;

#if !SDF_LARGE
template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads, kRaysBwdMinBlocks)
    raymarch_rays_bwd_kernel(const float* __restrict__ ox,
                             const float* __restrict__ oy, const float* __restrict__ oz,
                             const float* __restrict__ dx, const float* __restrict__ dy,
                             const float* __restrict__ dz, RenderArgs a,
                             const float* __restrict__ grad, const unsigned char* __restrict__ hit,
                             float* __restrict__ g_rays, float* __restrict__ depths,
                             float* __restrict__ partials) {
  float acc[kNAcc];
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < kNAcc; ++j) acc[j] = 0.0f;
  const float* P = scene_params();
  const long long n = a.local_npix;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    RayGrad gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float depth = __int_as_float(0x7fc00000);  // NaN: a ray the flag skips marches nowhere
    if (hit == nullptr || hit[i]) {
      const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
      tangent_pullback_ray<WANT_COLOR>(r, P, a, grad + (WANT_COLOR ? 3 : 1) * i, acc, gr, depth);
    }
    g_rays[i] = gr.ox;
    g_rays[n + i] = gr.oy;
    g_rays[2 * n + i] = gr.oz;
    g_rays[3 * n + i] = gr.dx;
    g_rays[4 * n + i] = gr.dy;
    g_rays[5 * n + i] = gr.dz;
    if (depths != nullptr) depths[i] = depth;
  }
  block_sum_to_row<kNParams>(acc, partials + (long long)blockIdx.x * kNParams);
}
#else
// The large-scene tier: the tangent march would carry a derivative per slot
// the distance reads across the whole march, so a ray is pulled back as the
// image backward pulls a pixel back, by a replay of its march and a sweep
// (pullback_ray_large), its parameter cotangents added to the warp's row of
// partials (raymarch_sums.cuh), which the launch zeroes first. The warp goes
// round the grid-stride loop as one; a ray past the end, or flagged as a
// miss, goes along with nothing to add.
template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads, kRaysBwdMinBlocks)
    raymarch_rays_bwd_kernel(const float* __restrict__ ox,
                             const float* __restrict__ oy, const float* __restrict__ oz,
                             const float* __restrict__ dx, const float* __restrict__ dy,
                             const float* __restrict__ dz, RenderArgs a,
                             const float* __restrict__ grad, const unsigned char* __restrict__ hit,
                             float* __restrict__ g_rays, float* __restrict__ depths,
                             float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  float* row = partials + ((long long)blockIdx.x * kBwdWarps + (threadIdx.x >> 5)) * kNParams;
  const float* P = scene_params();
  const long long n = a.local_npix;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long first = blockIdx.x * blockDim.x + (threadIdx.x - lane); first < n;
       first += stride) {
    const bool in = first + lane < n;
    const long long i = in ? first + lane : n - 1;
    const bool marched = in && (hit == nullptr || hit[i]);
    RayGrad gr = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float depth = __int_as_float(0x7fc00000);  // NaN: a ray the flag skips marches nowhere
    if (sdf_any(marched)) {
      const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
      float reached;
      pullback_ray_large<WANT_COLOR>(r, marched, P, a, grad + (WANT_COLOR ? 3 : 1) * i, row, gr,
                                     ReplayRows(), &reached);
      if (marched) depth = reached;
    }
    if (in) {
      g_rays[i] = gr.ox;
      g_rays[n + i] = gr.oy;
      g_rays[2 * n + i] = gr.oz;
      g_rays[3 * n + i] = gr.dx;
      g_rays[4 * n + i] = gr.dy;
      g_rays[5 * n + i] = gr.dz;
      if (depths != nullptr) depths[i] = depth;
    }
  }
}
#endif

// Scalars one backward sums: the parameter slots.
extern "C" int raymarch_rays_bwd_n_out() { return kNParams; }

// Blocks of the pullback kernel one SM of the current device holds at once,
// or a negative CUDA error.
extern "C" int raymarch_rays_bwd_resident(int want_color) {
  return want_color ? resident_blocks(raymarch_rays_bwd_kernel<true>, kBwdThreads)
                    : resident_blocks(raymarch_rays_bwd_kernel<false>, kBwdThreads);
}

// Rows of partials a launch over n rays writes (its grid size) on the
// current device, or a negative CUDA error.
extern "C" int raymarch_rays_bwd_rows(int n, int want_color) {
  const int blocks = want_color ? backward_grid_rows(raymarch_rays_bwd_kernel<true>, n)
                                : backward_grid_rows(raymarch_rays_bwd_kernel<false>, n);
  return blocks > 0 ? blocks * kRowsPerBlock : blocks;
}

// Launches both kernels on `stream`; returns the first CUDA error (0 when
// both launches were accepted). Each ray component holds n floats, `grad`
// n*3 floats (RGB) or n (depth), `g_rays` 6*n floats (the cotangents of ox,
// oy, oz, dx, dy, dz, one row each), `partials` rows*n_out floats with rows
// from raymarch_rays_bwd_rows(n, want_color), `out` n_out floats. `hit` is
// null (every ray is marched) or the forward's n hit flags (RGB only): a ray
// flagged 0 gets a zero cotangent and adds nothing. `depths` is null or n
// floats that take the depth each ray's march reached (before the final
// step in RGB; NaN for a ray the flag skipped).
extern "C" int raymarch_rays_bwd_launch(const void* params, const void* ox, const void* oy,
                                        const void* oz, const void* dx, const void* dy,
                                        const void* dz, int n, int iters, float depth0,
                                        float near_, float far_, int want_color,
                                        const void* grad, const void* hit, void* g_rays,
                                        void* depths, void* partials, int rows, void* out,
                                        void* stream) {
  if (iters < 1 || n <= 0 || rows <= 0 || rows % kRowsPerBlock != 0 ||
      (hit != nullptr && !want_color)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c[6] = {static_cast<const float*>(ox), static_cast<const float*>(oy),
                       static_cast<const float*>(oz), static_cast<const float*>(dx),
                       static_cast<const float*>(dy), static_cast<const float*>(dz)};
  const float* g = static_cast<const float*>(grad);
  const unsigned char* h = static_cast<const unsigned char*>(hit);
  float* gr = static_cast<float*>(g_rays);
  float* dep = static_cast<float*>(depths);
  float* part = static_cast<float*>(partials);
  cudaError_t err = copy_uniforms(static_cast<const float*>(params), nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (SDF_LARGE) {
    err = cudaMemsetAsync(part, 0, sizeof(float) * (size_t)rows * kNParams, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = rows / kRowsPerBlock;
  if (want_color) {
    raymarch_rays_bwd_kernel<true><<<blocks, kBwdThreads, 0, s>>>(c[0], c[1], c[2], c[3], c[4],
                                                                  c[5], a, g, h, gr, dep, part);
  } else {
    raymarch_rays_bwd_kernel<false><<<blocks, kBwdThreads, 0, s>>>(c[0], c[1], c[2], c[3], c[4],
                                                                   c[5], a, g, h, gr, dep, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kNParams > 0) {
    reduce_partials_kernel<<<kNParams, kReduceThreads, 0, s>>>(part, rows, kNParams,
                                                               static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
