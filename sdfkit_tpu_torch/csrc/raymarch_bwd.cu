// The backward sphere-trace kernels for Hopper (sm_90a): the pullback of the
// render, summed over all pixels, and the fixed-order sum of its partials.
//
// Replaces sdfkit_tpu/render/pallas/raymarch_kernel.py _pallas_render_image_bwd:
// built as it is, the store=None form that replays the march; built with
// SDF_STORE defined to 1, the form that takes the forward's depth history
// (`store`) and skips the replay. What bounds it on the card: arithmetic. A
// pixel runs about 46 forward scene evaluations (the march replay, the final
// step, 6 taps) and about 46 forward-and-reverse evaluations (the 6 taps, the
// final step and the 39-step sweep, each recomputing its forward); it reads
// 12 bytes of cotangent (4 in depth mode), and a block writes
// SDF_N_PARAMS + 19 floats. So, as in the forward kernel, everything per pixel
// stays in registers and thread-local memory: the ray comes from the pixel
// index, the 39 pre-step depths live in a per-thread array (the TPU kernel's
// VMEM scratch), and each sweep step recomputes its evaluation rather than
// storing residuals. With a store the replay's 39 evaluations go, and 4 bytes
// per step and pixel are read instead (a warp reads one step's 32 depths
// side by side).
//
// The sum over pixels: per-thread accumulators over a grid-stride loop
// (registers for a small scene, since every index is a compile-time constant
// after inlining; local memory for a large one), then raymarch_reduce.cuh.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval, SDF_N_PARAMS and the adjoints
// sdf_dist_vjp/sdf_eval_vjp, and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_bwd.cuh"
#include "raymarch_reduce.cuh"

#ifndef SDF_STORE
#define SDF_STORE 0
#endif
constexpr bool kHasStore = SDF_STORE != 0;
constexpr int kNOut = kSdfNOut;

template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads)
    raymarch_bwd_kernel(const float* __restrict__ P, const float* __restrict__ view19,
                        RenderArgs a, const float* __restrict__ grad,
                        const float* __restrict__ store, float* __restrict__ partials) {
  float acc[kNOut];
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < kNOut; ++j) acc[j] = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long local = blockIdx.x * blockDim.x + threadIdx.x; local < a.local_npix;
       local += stride) {
    pullback_pixel<WANT_COLOR, kHasStore>(a.pix0 + (int)local, P, view19, a,
                                          grad + (WANT_COLOR ? 3 : 1) * local, acc,
                                          acc + SDF_N_PARAMS, store);
  }
  block_sum_to_row<kNOut>(acc, partials + (long long)blockIdx.x * kNOut);
}

// Outputs of one backward: the parameter slots, 16 of inverse(view @ proj),
// 3 of the camera position.
extern "C" int raymarch_bwd_n_out() { return kNOut; }

// Rows of partials a launch over local_npix pixels writes (its grid size) on
// the current device, or a negative CUDA error.
extern "C" int raymarch_bwd_rows(int local_npix) { return backward_grid_rows(local_npix); }

// Launches both kernels on `stream`; returns the first CUDA error (0 when
// both launches were accepted). `grad` holds local_npix*3 floats (RGB) or
// local_npix (depth), `partials` rows*n_out floats with rows from
// raymarch_bwd_rows(local_npix), `out` n_out floats. `store` is the forward's
// depth history, iters*local_npix floats, in the SDF_STORE build and null in
// the replay build, which takes at most SDF_MAX_ITERS iterations.
extern "C" int raymarch_bwd_launch(const void* params, const void* view19, int width,
                                   int height, int pix0, int local_npix, int iters,
                                   float depth0, float near_, float far_, int want_color,
                                   const void* grad, const void* store, void* partials,
                                   int rows, void* out, void* stream) {
  if (iters < 1 || (!kHasStore && iters > SDF_MAX_ITERS) || local_npix <= 0 || rows <= 0 ||
      kHasStore != (store != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* P = static_cast<const float*>(params);
  const float* v = static_cast<const float*>(view19);
  const float* g = static_cast<const float*>(grad);
  const float* st = static_cast<const float*>(store);
  float* part = static_cast<float*>(partials);
  if (want_color) {
    raymarch_bwd_kernel<true><<<rows, kBwdThreads, 0, s>>>(P, v, a, g, st, part);
  } else {
    raymarch_bwd_kernel<false><<<rows, kBwdThreads, 0, s>>>(P, v, a, g, st, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<kNOut, kReduceThreads, 0, s>>>(part, rows, kNOut,
                                                          static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
