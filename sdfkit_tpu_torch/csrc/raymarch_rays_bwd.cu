// The ray-batch pullback kernels for Hopper (sm_90a): the cotangent of every
// ray, and the parameters' cotangents summed over all rays.
//
// The backward of what raymarch_rays_fwd.cu computes. In the JAX package this
// path (sdfkit_tpu/render/pallas/raymarch_kernel.py _render_fused_impl,
// _fused_bwd) has no TPU kernel of its own: its backward is jax.vjp of the
// plain path. Here it is the image pullback (raymarch_bwd.cuh pullback_ray:
// march replay, pullback of the final shade, reverse sweep in unit form)
// without the pullback of ray generation: the ray's own cotangent is the
// output. What bounds it on the card: latency, as for the image backward
// (raymarch_bwd.cu); per ray it reads 24 bytes of ray and 12 (RGB) or 4
// (depth) of cotangent and writes 24 bytes of ray cotangent, each component
// array contiguous. The parameters' cotangents are summed over a grid-stride
// loop in per-thread accumulators, then
// raymarch_reduce.cuh (one full wave of blocks; no atomics, so two launches
// give bit-identical sums).
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

template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    raymarch_rays_bwd_kernel(const float* __restrict__ ox,
                             const float* __restrict__ oy, const float* __restrict__ oz,
                             const float* __restrict__ dx, const float* __restrict__ dy,
                             const float* __restrict__ dz, RenderArgs a,
                             const float* __restrict__ grad, float* __restrict__ g_rays,
                             float* __restrict__ partials) {
  float acc[kNAcc];
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < kNAcc; ++j) acc[j] = 0.0f;
  const float* P = c_uniform;
  const long long n = a.local_npix;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
    RayGrad gr;
    pullback_ray<WANT_COLOR>(r, P, a, grad + (WANT_COLOR ? 3 : 1) * i, acc, gr);
    g_rays[i] = gr.ox;
    g_rays[n + i] = gr.oy;
    g_rays[2 * n + i] = gr.oz;
    g_rays[3 * n + i] = gr.dx;
    g_rays[4 * n + i] = gr.dy;
    g_rays[5 * n + i] = gr.dz;
  }
  block_sum_to_row<kNParams>(acc, partials + (long long)blockIdx.x * kNParams);
}

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
  return want_color ? backward_grid_rows(raymarch_rays_bwd_kernel<true>, n)
                    : backward_grid_rows(raymarch_rays_bwd_kernel<false>, n);
}

// Launches both kernels on `stream`; returns the first CUDA error (0 when
// both launches were accepted). Each ray component holds n floats, `grad`
// n*3 floats (RGB) or n (depth), `g_rays` 6*n floats (the cotangents of ox,
// oy, oz, dx, dy, dz, one row each), `partials` rows*n_out floats with rows
// from raymarch_rays_bwd_rows(n, want_color), `out` n_out floats.
extern "C" int raymarch_rays_bwd_launch(const void* params, const void* ox, const void* oy,
                                        const void* oz, const void* dx, const void* dy,
                                        const void* dz, int n, int iters, float depth0,
                                        float near_, float far_, int want_color,
                                        const void* grad, void* g_rays, void* partials,
                                        int rows, void* out, void* stream) {
  if (iters < 1 || n <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c[6] = {static_cast<const float*>(ox), static_cast<const float*>(oy),
                       static_cast<const float*>(oz), static_cast<const float*>(dx),
                       static_cast<const float*>(dy), static_cast<const float*>(dz)};
  const float* g = static_cast<const float*>(grad);
  float* gr = static_cast<float*>(g_rays);
  float* part = static_cast<float*>(partials);
  cudaError_t err = copy_uniforms(static_cast<const float*>(params), nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (want_color) {
    raymarch_rays_bwd_kernel<true><<<rows, kBwdThreads, 0, s>>>(c[0], c[1], c[2], c[3], c[4], c[5],
                                                                a, g, gr, part);
  } else {
    raymarch_rays_bwd_kernel<false><<<rows, kBwdThreads, 0, s>>>(c[0], c[1], c[2], c[3], c[4], c[5],
                                                                 a, g, gr, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kNParams > 0) {
    reduce_partials_kernel<<<kNParams, kReduceThreads, 0, s>>>(part, rows, kNParams,
                                                               static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
