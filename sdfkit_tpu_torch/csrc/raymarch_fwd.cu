// The forward sphere-trace kernel for Hopper (sm_90a), one thread per pixel.
//
// Replaces sdfkit_tpu/render/pallas/raymarch_kernel.py _pallas_render_image_flat:
// built as it is, the want_store=False form; built with SDF_STORE defined to
// 1, the form that also writes the depth history. What bounds it on the
// card: arithmetic. A pixel runs about 46 scene evaluations (39 march steps,
// the final colour step, 6 normal taps) and writes 12 bytes (RGB) or 4
// (depth); it reads nothing per pixel. So the design keeps the whole march
// in registers: rays come from the pixel index and 19 view scalars, and the
// only device memory read is the flat scene parameter buffer (a few hundred
// bytes, cached). The TPU's 256x128 tile, lane padding and SMEM/VMEM
// parameter split do not carry over: a thread past local_npix returns before
// it marches. The depth history adds 4 bytes written per step and pixel
// (160 per pixel at 40 steps, 13 times the RGB), step-major so that a warp's
// 32 writes of one step are one 128-byte line.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_fwd.cuh"

#ifndef SDF_STORE
#define SDF_STORE 0
#endif
constexpr bool kWantStore = SDF_STORE != 0;
constexpr int kThreads = 128;

template <bool WANT_COLOR>
__global__ void __launch_bounds__(kThreads)
    raymarch_fwd_kernel(const float* __restrict__ P, const float* __restrict__ view19,
                        RenderArgs a, float* __restrict__ out, float* __restrict__ store) {
  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= a.local_npix) return;
  shade_pixel<WANT_COLOR, kWantStore>(a.pix0 + local, P, view19, a, out, store);
}

// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). `out` holds local_npix*3 floats (RGB) or local_npix (depth);
// `store` holds iters*local_npix floats in the SDF_STORE build and is null
// otherwise.
extern "C" int raymarch_fwd_launch(const void* params, const void* view19, int width,
                                   int height, int pix0, int local_npix, int iters,
                                   float depth0, float near_, float far_, int want_color,
                                   void* out, void* store, void* stream) {
  if (kWantStore != (store != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (local_npix <= 0) return 0;
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  const int blocks = (local_npix + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* P = static_cast<const float*>(params);
  const float* v = static_cast<const float*>(view19);
  float* o = static_cast<float*>(out);
  float* st = static_cast<float*>(store);
  if (want_color) {
    raymarch_fwd_kernel<true><<<blocks, kThreads, 0, s>>>(P, v, a, o, st);
  } else {
    raymarch_fwd_kernel<false><<<blocks, kThreads, 0, s>>>(P, v, a, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
