// The backward sphere-trace kernels for Hopper (sm_90a): the pullback of the
// render, summed over all pixels, and the fixed-order sum of its partials.
//
// Replaces sdfkit_tpu/render/pallas/raymarch_kernel.py _pallas_render_image_bwd
// (store=None). What bounds it on the card: arithmetic. A pixel runs about 46
// forward scene evaluations (the march replay, the final step, 6 taps) and
// about 46 forward-and-reverse evaluations (the 6 taps, the final step and
// the 39-step sweep, each recomputing its forward); it reads 12 bytes of
// cotangent (4 in depth mode), and a block writes SDF_N_PARAMS + 19 floats.
// So, as in the forward kernel, everything per pixel stays in registers and
// thread-local memory: the ray comes from the pixel index, the 39 pre-step
// depths live in a per-thread array (the TPU kernel's VMEM scratch), and each
// sweep step recomputes its evaluation rather than storing residuals.
//
// The sum over pixels. The TPU kernel added every tile's scalars into one
// revisited output block, leaning on its grid running in order. Blocks here
// run in any order, so: a fixed grid (a multiple of the SM count) walks the
// pixels with a grid-stride loop; each thread keeps SDF_N_PARAMS + 19
// accumulators across the loop (registers for a small scene, since every
// index is a compile-time constant after inlining; local memory for a large
// one); a block reduces them with warp shuffles and a shared-memory pass in a
// fixed order and writes one row of partials; and reduce_partials_kernel sums
// the rows in a fixed order. No atomics: two launches on the same card give
// bit-identical gradients.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval, SDF_N_PARAMS and the adjoints
// sdf_dist_vjp/sdf_eval_vjp, and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_bwd.cuh"

constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kReduceThreads = 256;
constexpr int kNOut = kSdfNOut;

template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads)
    raymarch_bwd_kernel(const float* __restrict__ P, const float* __restrict__ view19,
                        RenderArgs a, const float* __restrict__ grad,
                        float* __restrict__ partials) {
  float acc[kNOut];
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < kNOut; ++j) acc[j] = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long local = blockIdx.x * blockDim.x + threadIdx.x; local < a.local_npix;
       local += stride) {
    pullback_pixel<WANT_COLOR>(a.pix0 + (int)local, P, view19, a,
                               grad + (WANT_COLOR ? 3 : 1) * local, acc, acc + SDF_N_PARAMS);
  }
  // Block sum of each accumulator: shuffles within a warp, then the warps'
  // sums in order. Two rows of shared memory alternate, so one barrier per
  // accumulator is enough.
  __shared__ float warp_sums[2][kBwdWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < kNOut; ++j) {
    float v = acc[j];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[j & 1][warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = warp_sums[j & 1][0];
      for (int w = 1; w < kBwdWarps; ++w) s += warp_sums[j & 1][w];
      partials[(long long)blockIdx.x * kNOut + j] = s;
    }
  }
}

// out[j] = sum over rows of partials[row][j], one block per j: each thread
// sums its rows in order, then a fixed tree in shared memory.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ partials, int rows, int n_out,
                           float* __restrict__ out) {
  __shared__ float sums[kReduceThreads];
  const int j = blockIdx.x;
  float s = 0.0f;
  for (int row = threadIdx.x; row < rows; row += kReduceThreads) {
    s += partials[(long long)row * n_out + j];
  }
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = sums[0];
}

// Outputs of one backward: the parameter slots, 16 of inverse(view @ proj),
// 3 of the camera position.
extern "C" int raymarch_bwd_n_out() { return kNOut; }

// Rows of partials a launch over local_npix pixels writes (its grid size) on
// the current device, or a negative CUDA error.
extern "C" int raymarch_bwd_rows(int local_npix) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int needed = (local_npix + kBwdThreads - 1) / kBwdThreads;
  const int fixed = sms * kBlocksPerSm;
  return needed < fixed ? needed : fixed;
}

// Launches both kernels on `stream`; returns the first CUDA error (0 when
// both launches were accepted). `grad` holds local_npix*3 floats (RGB) or
// local_npix (depth), `partials` rows*n_out floats with rows from
// raymarch_bwd_rows(local_npix), `out` n_out floats.
extern "C" int raymarch_bwd_launch(const void* params, const void* view19, int width,
                                   int height, int pix0, int local_npix, int iters,
                                   float depth0, float near_, float far_, int want_color,
                                   const void* grad, void* partials, int rows, void* out,
                                   void* stream) {
  if (iters < 1 || iters > SDF_MAX_ITERS || local_npix <= 0 || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* P = static_cast<const float*>(params);
  const float* v = static_cast<const float*>(view19);
  const float* g = static_cast<const float*>(grad);
  float* part = static_cast<float*>(partials);
  if (want_color) {
    raymarch_bwd_kernel<true><<<rows, kBwdThreads, 0, s>>>(P, v, a, g, part);
  } else {
    raymarch_bwd_kernel<false><<<rows, kBwdThreads, 0, s>>>(P, v, a, g, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<kNOut, kReduceThreads, 0, s>>>(part, rows, kNOut,
                                                          static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
