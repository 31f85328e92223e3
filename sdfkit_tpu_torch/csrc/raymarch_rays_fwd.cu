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
// not carry over: a thread past n returns before it reads.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval and then includes this file.
#include <cuda_runtime.h>

#include "raymarch_fwd.cuh"

constexpr int kRayThreads = 128;

template <bool WANT_COLOR>
__global__ void __launch_bounds__(kRayThreads)
    raymarch_rays_fwd_kernel(const float* __restrict__ P, const float* __restrict__ ox,
                             const float* __restrict__ oy, const float* __restrict__ oz,
                             const float* __restrict__ dx, const float* __restrict__ dy,
                             const float* __restrict__ dz, RenderArgs a,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.local_npix) return;
  const Ray r{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  shade_ray<WANT_COLOR>(r, P, a, out + (WANT_COLOR ? 3 : 1) * (long long)i);
}

// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted). Each of the six ray components holds n floats; `out` holds n*3
// floats (RGB) or n (depth).
extern "C" int raymarch_rays_fwd_launch(const void* params, const void* ox, const void* oy,
                                        const void* oz, const void* dx, const void* dy,
                                        const void* dz, int n, int iters, float depth0,
                                        float near_, float far_, int want_color, void* out,
                                        void* stream) {
  if (n <= 0) return 0;
  RenderArgs a{0, 0, 0, n, iters, depth0, near_, far_};
  const int blocks = (n + kRayThreads - 1) / kRayThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* P = static_cast<const float*>(params);
  const float* c[6] = {static_cast<const float*>(ox), static_cast<const float*>(oy),
                       static_cast<const float*>(oz), static_cast<const float*>(dx),
                       static_cast<const float*>(dy), static_cast<const float*>(dz)};
  float* o = static_cast<float*>(out);
  if (want_color) {
    raymarch_rays_fwd_kernel<true><<<blocks, kRayThreads, 0, s>>>(P, c[0], c[1], c[2], c[3],
                                                                  c[4], c[5], a, o);
  } else {
    raymarch_rays_fwd_kernel<false><<<blocks, kRayThreads, 0, s>>>(P, c[0], c[1], c[2], c[3],
                                                                   c[4], c[5], a, o);
  }
  return static_cast<int>(cudaGetLastError());
}
