// The forward sphere-trace kernel for Hopper (sm_90a), one thread per pixel.
//
// Replaces sdfkit_tpu/render/pallas/raymarch_kernel.py _pallas_render_image_flat:
// built as it is, the want_store=False form; built with SDF_STORE defined to
// 1, the form that also writes the depth history.
//
// What bounds it on the card: the rate at which an SM starts instructions.
// A pixel runs about 46 scene evaluations (39 march steps, the final colour
// step, 6 normal taps), writes 12 bytes (RGB) or 4 (depth) and reads nothing
// per pixel. Measured on an H100 with SphereRepeat at 1920x1080x40: with the
// division written as `/` and the uniforms read through a pointer, the march
// loop executed 135 instructions per evaluation, and times its 39 steps a pixel
// that was 0.84 of all that 132 SMs can start at their highest clock in 0.390 ms,
// with the final step and the six taps still to come; more warps
// or another block size change nothing (64, 128 and 256 threads are within
// 0.5% of each other). So the design keeps
// the whole march in registers (rays come from the pixel index and 19 view
// scalars) and shortens the instruction stream:
//   * the scene compiler writes a division by a uniform, the `x / c` under
//     the floor of a repetition, as a reciprocal that the compiler lifts out
//     of the march loop and two multiply-adds, where the IEEE division cost a
//     reciprocal seed, two Newton steps and a range check per evaluation: 135
//     instructions became 93, 0.390 ms became 0.291;
//   * the scene parameters and the view come through constant memory
//     (raymarch_uniforms.cuh): read through a pointer, four of them were
//     loaded again in every pass of the loop; as operands they cost nothing:
//     88 instructions, 32 registers where there were 40, 0.268 ms.
// The square roots stay IEEE. The march loop alone then executed 0.79 of what
// the card can, and the final step and the six taps run outside it: what was
// left is the square roots, the scene's own operations and work that changes
// no bit, which the shared header (raymarch_fwd.cuh) now skips: a warp leaves
// the march once a group of steps has left all its depths bit for bit where
// they were (21% of SphereRepeat's warp-steps), and a sky lane is not shaded:
// 0.2705 -> 0.2367 ms, a mostly-sky frame 0.0787 -> 0.0762. The TPU's 256x128
// tile, lane padding and SMEM/VMEM parameter split do not carry over: a
// thread past local_npix returns before it marches. The depth history adds 4
// bytes written per step and pixel (160 per pixel at 40 steps, 13 times the
// RGB), step-major so that a warp's 32 writes of one step are one 128-byte
// line; walking a pointer down the rows took the build from 35 registers and
// 12 blocks an SM to 32 and 16, and a settled warp writes its remaining rows
// with stores alone: 0.3017 -> 0.2572 ms.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_fwd.cuh"
#include "raymarch_uniforms.cuh"

#ifndef SDF_STORE
#define SDF_STORE 0
#endif
constexpr bool kWantStore = SDF_STORE != 0;
// Threads of a block: 64, 128 and 256 measured within 0.5% of each other on
// an H100. The register allocation is left to the compiler, which reaches 16
// blocks an SM on its own (32 registers); the kernel is not short of warps,
// and a budget set for 12 or 16 blocks measured the same.
constexpr int kThreads = 128;

template <bool WANT_COLOR>
__global__ void __launch_bounds__(kThreads)
    raymarch_fwd_kernel(RenderArgs a, float* __restrict__ out, float* __restrict__ store) {
  const float* P = scene_params();
  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  if (local >= a.local_npix) return;
  shade_pixel<WANT_COLOR, kWantStore>(a.pix0 + local, P, c_uniform + SDF_N_PARAMS, a, out,
                                      store);
}

// Blocks of the kernel one SM of the current device holds at once, or a
// negative CUDA error.
extern "C" int raymarch_fwd_resident(int want_color) {
  int blocks = 0;
  const cudaError_t err =
      want_color ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, raymarch_fwd_kernel<true>, kThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, raymarch_fwd_kernel<false>, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches on `stream`; returns the first CUDA error (0 when the copies and
// the launch were accepted). `out` holds local_npix*3 floats (RGB) or local_npix (depth);
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
  float* o = static_cast<float*>(out);
  float* st = static_cast<float*>(store);
  const cudaError_t err = copy_uniforms(static_cast<const float*>(params),
                                        static_cast<const float*>(view19), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (want_color) {
    raymarch_fwd_kernel<true><<<blocks, kThreads, 0, s>>>(a, o, st);
  } else {
    raymarch_fwd_kernel<false><<<blocks, kThreads, 0, s>>>(a, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
