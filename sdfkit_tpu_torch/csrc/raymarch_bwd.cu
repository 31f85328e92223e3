// The backward sphere-trace kernels for Hopper (sm_90a): the pullback of the
// render, summed over all pixels, and the fixed-order sum of its partials.
//
// Replaces sdfkit_tpu/render/pallas/raymarch_kernel.py _pallas_render_image_bwd:
// built as it is, the store=None form that replays the march; built with
// SDF_STORE defined to 1, the form that takes the forward's depth history
// (`store`) and skips the replay.
//
// What bounds it on the card: neither bytes nor arithmetic at its peak. A
// pixel reads 12 bytes of cotangent (4 in depth mode) and a block writes
// SDF_N_PARAMS + 19 floats; its work is about 46 forward scene evaluations
// (the march replay, the final step, 6 taps) and about 46 gradients of the
// scene, each a chain of dependent operations with IEEE divisions and square
// roots in it. The TPU kernel's form of that work (a seeded vjp per sweep
// step, each waiting for the last) ran at 146 registers and three blocks an
// SM, and what it lacked was warps to cover the chains: a register budget for
// four blocks alone made it 19% faster, and dropping the replay's evaluations
// (the store build) did nothing. So the design
//   * keeps the chain short: the sweep and the taps are in unit form
//     (raymarch_bwd.cuh), so the 39 gradients of a sweep do not wait for each
//     other, and a division by a uniform costs a multiply and two
//     multiply-adds (the scene compiler);
//   * keeps warps in flight: the register budget is set for five blocks an SM
//     (raymarch_reduce.cuh), and the scene parameters and the 19 view scalars
//     come through constant memory (raymarch_uniforms.cuh), so that they are
//     operands of the instructions that use them and not registers held
//     across the loop (4.5% on SphereRepeat at 1920x1080x40, 10% on a frame
//     that is mostly sky, against reading them from device memory);
//   * launches one full wave of blocks (raymarch_reduce.cuh).
// With these the kernel executes between 0.64 and 0.72 of the instructions an
// H100 can (the least is its SASS loops times their passes over its time, the
// most adds every other instruction once a pixel), and neither more warps (6
// or 8 blocks an SM) nor two sweep steps in flight make it faster: what is
// left is the instruction count. The running sums over a thread's pixels stay
// in the thread's own array, registers for a small scene: with the 19 view
// sums, or all of them, in shared memory (one column per thread) the kernel
// measured 0-0.6% and 1.5% slower at every register budget, since what the
// compiler spills instead costs less than the copies.
// Everything per pixel stays in registers and thread-local memory: the ray
// comes from the pixel index and the kept depths live in a per-thread array
// (the TPU kernel's VMEM scratch).
//
// With a store (SDF_STORE) the replay goes, and 4 bytes per step and pixel
// are read instead: 332 MB per 1080p frame at 40 iterations, read once, so
// every read goes to device memory. Read at the head of each sweep step, the
// depth held up the step behind a device-memory latency, 39 times a pixel
// (the first multiply-add of the step waited on the load). So the store
// build stages a hit pixel's depths in shared memory ahead of its sweep
// (StagedRows): each thread copies its own column of the store with
// cp.async, 4 bytes a step (a warp's 32 copies of one step are one 128-byte
// line), into a ring of kStoreStages segments of kStoreStageSteps steps
// (24 KB a block, 120 KB at five blocks an SM). The copies of the first
// segments start as soon as the pixel is known to hit, before its taps, and
// each segment's copies are issued kStoreStages - 1 segments ahead of its
// sweep, from the last step down. A thread reads only what it copied, so no
// barrier ties the warps of a block together, and a sky pixel, which needs
// only its final depth, copies and waits for nothing. The arithmetic is the
// replay-free sweep's, step for step. The copies and the sweep walk pointers
// (a shared-window address up, a store pointer by the row stride, the ring
// read down) rather than index: 9 instructions a copy where indexing took 18.
// Measured on an H100 with SphereRepeat at 1920x1080x40: 1.268 -> 1.167 ms
// (indexed copies 1.222), no slower on a frame that is mostly sky (0.07 ms).
// A register prefetch of the next step's depth (1.173 ms) hides the latency
// about as well; other ring shapes (2x16, 4x8, 2x32 steps) measured no
// faster, and copies unrolled to constant offsets slower (1.343 ms, with more
// spilled).
//
// A scene of the large tier (SDF_LARGE: more than LARGE_SCENE_SLOTS slots,
// sdf/compile.py) is pulled back by the large tier of raymarch_bwd.cuh: the
// same replay, taps and sweep, its parameter cotangents added by the warp to
// a row of partials of its own (raymarch_sums.cuh), a row per warp, so that
// no thread keeps an array whose length is a number of slots. The launch
// zeroes the rows first; the view's 19 sums stay in each thread and are
// summed over the warp at the end; reduce_partials_kernel then sums the rows
// in order, so two launches give bit-identical sums in this tier too.
//
// The build (render/cuda/build.py) compiles a generated translation unit that
// defines the scene's sdf_dist/sdf_eval, SDF_N_PARAMS and the adjoints
// sdf_dist_unit/sdf_eval_vjp (or the large tier's), and then includes this
// file.
#include <cuda_runtime.h>

#include "raymarch_bwd.cuh"
#include "raymarch_reduce.cuh"
#include "raymarch_uniforms.cuh"

#ifndef SDF_STORE
#define SDF_STORE 0
#endif
constexpr bool kHasStore = SDF_STORE != 0;
constexpr int kNOut = kSdfNOut;

#if SDF_STORE
// The ring: kStoreStages segments of kStoreStageSteps steps, one float per
// step and thread, the thread's column at ring[threadIdx.x], step j of a
// segment kBwdThreads floats further on.
constexpr int kStoreStages = 3;
constexpr int kStoreStageSteps = 16;
constexpr int kRingFloats = kStoreStages * kStoreStageSteps * kBwdThreads;

// 4 bytes from device memory to shared memory (a shared-window address),
// asynchronously (cp.async).
__device__ __forceinline__ void copy_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A pixel's depth history staged through the thread's column of the ring
// (see the head of this file). Segment k holds rows [lo, hi) with
// hi = steps - k * kStoreStageSteps, in stage k % kStoreStages; the sweep
// takes segment k once its copies have landed, after issuing those of
// segment k + kStoreStages - 1. Every issue commits a group, empty where the
// segment is past row 0, so that the count of groups in flight is the same
// at every wait.
struct StagedRows {
  static constexpr bool kStored = true;
  const float* at;  // the pixel's column of the store
  long long stride;
  float* column;    // the thread's column of the ring

  __device__ float last(int steps) const { return at[steps * stride]; }

  __device__ void issue(int steps, int k) const {
    const int hi = steps - k * kStoreStageSteps;
    const int lo = hi > kStoreStageSteps ? hi - kStoreStageSteps : 0;
    unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        column + (k % kStoreStages) * kStoreStageSteps * kBwdThreads));
    const float* src = at + lo * stride;
#pragma unroll 1
    for (int i = lo; i < hi; ++i, dst += kBwdThreads * 4, src += stride) copy_async4(dst, src);
    commit_async();
  }

  __device__ void on_hit(int steps) const {
#pragma unroll
    for (int k = 0; k < kStoreStages - 1; ++k) issue(steps, k);
  }

#if !SDF_LARGE
  __device__ float sweep(const Ray& r, int steps, float g, const float* P, RayGrad& gr,
                         float* gP) const {
#else
  // The large tier's: a lane that goes along (u = 0) steps at depth0.
  __device__ float sweep(const Ray& r, int steps, float g, float u, float depth0, const float* P,
                         RayGrad& gr, float* gP) const {
#endif
    const int segments = (steps + kStoreStageSteps - 1) / kStoreStageSteps;
#pragma unroll 1
    for (int k = 0; k < segments; ++k) {
      issue(steps, k + kStoreStages - 1);
      wait_async<kStoreStages - 1>();
      const int hi = steps - k * kStoreStageSteps;
      const int lo = hi > kStoreStageSteps ? hi - kStoreStageSteps : 0;
      const float* src =
          column + ((k % kStoreStages) * kStoreStageSteps + hi - 1 - lo) * kBwdThreads;
#if !SDF_LARGE
#pragma unroll 1
      for (int i = hi - 1; i >= lo; --i, src -= kBwdThreads) g = step_vjp(r, *src, g, P, gr, gP);
#else
      float d;
#pragma unroll 1
      for (int i = hi - 1; i >= lo; --i, src -= kBwdThreads) {
        g = step_vjp_large(r, u != 0.0f ? *src : depth0, g, u, P, gr, gP, &d);
      }
#endif
    }
    return g;
  }
};
#endif

#if !SDF_LARGE
template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    raymarch_bwd_kernel(RenderArgs a, const float* __restrict__ grad,
                        const float* __restrict__ store, float* __restrict__ partials) {
  float acc[kNOut];  // the thread's running sums: parameters, then the view
#pragma unroll kSdfAccUnroll
  for (int j = 0; j < kNOut; ++j) acc[j] = 0.0f;
  const float* P = scene_params();
  const float* view19 = c_uniform + SDF_N_PARAMS;
  const long long stride = (long long)gridDim.x * blockDim.x;
#if SDF_STORE
  __shared__ float ring[kRingFloats];
#endif
  for (long long local = blockIdx.x * blockDim.x + threadIdx.x; local < a.local_npix;
       local += stride) {
#if SDF_STORE
    pullback_pixel<WANT_COLOR>(a.pix0 + (int)local, P, view19, a,
                               grad + (WANT_COLOR ? 3 : 1) * local, acc, acc + SDF_N_PARAMS,
                               StagedRows{store + local, a.local_npix, ring + threadIdx.x});
#else
    pullback_pixel<WANT_COLOR>(a.pix0 + (int)local, P, view19, a,
                               grad + (WANT_COLOR ? 3 : 1) * local, acc, acc + SDF_N_PARAMS);
#endif
  }
  block_sum_to_row<kNOut>(acc, partials + (long long)blockIdx.x * kNOut);
}
#else
// The large-scene tier (raymarch_bwd.cuh, raymarch_sums.cuh): a row of
// partials per warp, which the launch zeroes first. The parameters' sums go
// to it as the warp's adds; the view's 19 stay in each thread and are summed
// over the warp at the end. The pixels of a warp are 32 neighbours, and the
// warp goes round the grid-stride loop as one: a lane past the end goes
// along with nothing to add.
template <bool WANT_COLOR>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    raymarch_bwd_kernel(RenderArgs a, const float* __restrict__ grad,
                        const float* __restrict__ store, float* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  float* row = partials + ((long long)blockIdx.x * kBwdWarps + (threadIdx.x >> 5)) * kNOut;
  float gV[kViewScalars];
#pragma unroll
  for (int j = 0; j < kViewScalars; ++j) gV[j] = 0.0f;
  const float* P = scene_params();
  const float* view19 = c_uniform + SDF_N_PARAMS;
  const long long stride = (long long)gridDim.x * blockDim.x;
#if SDF_STORE
  __shared__ float ring[kRingFloats];
#endif
  for (long long first = blockIdx.x * blockDim.x + (threadIdx.x - lane); first < a.local_npix;
       first += stride) {
    const bool active = first + lane < a.local_npix;
    const long long local = active ? first + lane : a.local_npix - 1;
    const float* g = grad + (WANT_COLOR ? 3 : 1) * local;
#if SDF_STORE
    pullback_pixel_large<WANT_COLOR>(a.pix0 + (int)local, active, P, view19, a, g, row, gV,
                                     StagedRows{store + local, a.local_npix, ring + threadIdx.x});
#else
    pullback_pixel_large<WANT_COLOR>(a.pix0 + (int)local, active, P, view19, a, g, row, gV);
#endif
  }
#pragma unroll
  for (int j = 0; j < kViewScalars; ++j) {
    float v = gV[j];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) row[SDF_N_PARAMS + j] = v;
  }
}
#endif

// Outputs of one backward: the parameter slots, 16 of inverse(view @ proj),
// 3 of the camera position.
extern "C" int raymarch_bwd_n_out() { return kNOut; }

// Blocks of the pullback kernel one SM of the current device holds at once,
// or a negative CUDA error.
extern "C" int raymarch_bwd_resident(int want_color) {
  return want_color ? resident_blocks(raymarch_bwd_kernel<true>, kBwdThreads)
                    : resident_blocks(raymarch_bwd_kernel<false>, kBwdThreads);
}

// Rows of partials a launch over local_npix pixels writes (its grid size, or
// in the large tier a row per warp) on the current device, or a negative
// CUDA error.
extern "C" int raymarch_bwd_rows(int local_npix, int want_color) {
  const int blocks = want_color ? backward_grid_rows(raymarch_bwd_kernel<true>, local_npix)
                                : backward_grid_rows(raymarch_bwd_kernel<false>, local_npix);
  return blocks > 0 ? blocks * kRowsPerBlock : blocks;
}

// Launches both kernels on `stream`; returns the first CUDA error (0 when
// the copies and both launches were accepted). `grad` holds local_npix*3
// floats (RGB) or local_npix (depth), `partials` rows*n_out floats with rows
// from raymarch_bwd_rows(local_npix, want_color), `out` n_out floats. `store`
// is the forward's depth history, iters*local_npix floats, in the SDF_STORE
// build and null in the replay build.
extern "C" int raymarch_bwd_launch(const void* params, const void* view19, int width,
                                   int height, int pix0, int local_npix, int iters,
                                   float depth0, float near_, float far_, int want_color,
                                   const void* grad, const void* store, void* partials,
                                   int rows, void* out, void* stream) {
  if (iters < 1 || local_npix <= 0 || rows <= 0 || rows % kRowsPerBlock != 0 ||
      kHasStore != (store != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = copy_uniforms(static_cast<const float*>(params),
                                  static_cast<const float*>(view19), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* g = static_cast<const float*>(grad);
  const float* st = static_cast<const float*>(store);
  float* part = static_cast<float*>(partials);
  if (SDF_LARGE) {
    err = cudaMemsetAsync(part, 0, sizeof(float) * (size_t)rows * kNOut, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = rows / kRowsPerBlock;
  if (want_color) {
    raymarch_bwd_kernel<true><<<blocks, kBwdThreads, 0, s>>>(a, g, st, part);
  } else {
    raymarch_bwd_kernel<false><<<blocks, kBwdThreads, 0, s>>>(a, g, st, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<kNOut, kReduceThreads, 0, s>>>(part, rows, kNOut,
                                                          static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
