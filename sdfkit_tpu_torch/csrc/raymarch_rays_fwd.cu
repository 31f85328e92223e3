// The ray-batch forward kernel for Hopper (sm_90a), one thread per ray.
//
// Replaces sdfkit_tpu/render/pallas/raymarch_kernel.py _pallas_render_flat
// (behind render_rays_fused / render_depth_rays_fused): the march and shade of
// the image kernel for rays given as arrays, with no ray generation. What
// bounds it on the card: arithmetic, as for the image kernel (about 46 scene
// evaluations per ray), beside 24 bytes read and 12 (RGB) or 4 (depth)
// written per ray. The rays come as six component arrays of n floats each
// (structure of arrays), so a warp reads 128 contiguous bytes per component;
// the TPU wrapper's zero padding to whole 256x128 tiles (_pack_rays) does
// not carry over: a thread past n returns before it reads. The march and the
// shading are the image kernel's (raymarch_fwd.cuh), with its exits that
// change no bit: 0.2635 -> 0.2279 ms on the frame's rays in order, 0.2640 ->
// 0.2635 shuffled (no warp settles together), 0.0711 -> 0.0675 on a frame
// that is mostly sky.
//
// A render that autograd records also writes one byte per ray, whether it
// hit (WANT_HIT, a separate instance: a render that is not differentiated
// runs the kernel without it); the ray-batch backward skips the rays that
// did not, whose colour is the sky's constant.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_fwd.cuh"
#include "raymarch_uniforms.cuh"

constexpr int kRayThreads = 128;

template <bool WANT_COLOR, bool WANT_HIT>
__global__ void __launch_bounds__(kRayThreads)
    raymarch_rays_fwd_kernel(const float* __restrict__ ox,
                             const float* __restrict__ oy, const float* __restrict__ oz,
                             const float* __restrict__ dx, const float* __restrict__ dy,
                             const float* __restrict__ dz, RenderArgs a,
                             float* __restrict__ out, unsigned char* __restrict__ hit) {
  const float* P = scene_params();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.local_npix) return;
  const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  shade_ray<WANT_COLOR, false, WANT_HIT>(r, P, a, out + (WANT_COLOR ? 3 : 1) * (long long)i,
                                         nullptr, 0, WANT_HIT ? hit + i : nullptr);
}

// Blocks of the kernel one SM of the current device holds at once, or a
// negative CUDA error.
extern "C" int raymarch_rays_fwd_resident(int want_color) {
  int blocks = 0;
  const cudaError_t err =
      want_color ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, raymarch_rays_fwd_kernel<true, false>, kRayThreads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, raymarch_rays_fwd_kernel<false, false>, kRayThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches on `stream`; returns the first CUDA error (0 when the copy and the
// launch were accepted). Each of the six ray components holds n floats; `out` holds n*3
// floats (RGB) or n (depth). `hit` is null, or n bytes that take each ray's
// hit flag (RGB only).
extern "C" int raymarch_rays_fwd_launch(const void* params, const void* ox, const void* oy,
                                        const void* oz, const void* dx, const void* dy,
                                        const void* dz, int n, int iters, float depth0,
                                        float near_, float far_, int want_color, void* out,
                                        void* hit, void* stream) {
  if (hit != nullptr && !want_color) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  const int blocks = (n + kRayThreads - 1) / kRayThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c[6] = {static_cast<const float*>(ox), static_cast<const float*>(oy),
                       static_cast<const float*>(oz), static_cast<const float*>(dx),
                       static_cast<const float*>(dy), static_cast<const float*>(dz)};
  float* o = static_cast<float*>(out);
  unsigned char* h = static_cast<unsigned char*>(hit);
  const cudaError_t err = copy_uniforms(static_cast<const float*>(params), nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h != nullptr) {
    raymarch_rays_fwd_kernel<true, true><<<blocks, kRayThreads, 0, s>>>(c[0], c[1], c[2], c[3],
                                                                        c[4], c[5], a, o, h);
  } else if (want_color) {
    raymarch_rays_fwd_kernel<true, false><<<blocks, kRayThreads, 0, s>>>(c[0], c[1], c[2], c[3],
                                                                         c[4], c[5], a, o, h);
  } else {
    raymarch_rays_fwd_kernel<false, false><<<blocks, kRayThreads, 0, s>>>(c[0], c[1], c[2], c[3],
                                                                          c[4], c[5], a, o, h);
  }
  return static_cast<int>(cudaGetLastError());
}
