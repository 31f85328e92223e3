// The sum over pixels (or rays) that both backward kernels end in.
//
// The TPU kernel added every tile's scalars into one revisited output block,
// leaning on its grid running in order. Blocks here run in any order, so: a
// fixed grid walks the work with a grid-stride loop; each thread keeps its
// running sums across the loop; a block reduces them with warp shuffles and a
// shared-memory pass in a fixed order and writes one row of partials
// (block_sum_to_row); and reduce_partials_kernel sums the rows in a fixed
// order. No atomics: two launches on the same card give bit-identical sums.
//
// The grid is as many blocks as the card holds at once (the kernel's
// resident blocks per SM, asked of the occupancy calculator, times the SMs).
// A pullback kernel is bound by latency and lives on the warps in flight: a
// grid of a fixed eight blocks per SM ran as 2.7 waves of three resident
// blocks, the last one a third empty, and with six resident it would run as
// 1.3. One full wave has no tail but the spread between threads, whose
// pixels are strided over the whole frame and so cost about the same.
#pragma once

#include <cuda_runtime.h>

constexpr int kBwdThreads = 128;
// Resident blocks per SM that the pullback kernels' register allocation aims
// at: 65536 registers / 128 threads / 5 blocks allows 96 a thread. Measured
// on an H100 with SphereRepeat at 1920x1080x40, the image backward: 4 blocks
// (128 registers, 24 bytes spilled) 1.428 ms, 5 (288 bytes) 1.384, 6 (80
// registers, 364 bytes) 1.412, and 8 no faster than 6. Warps pay up to about
// 20 an SM, and 5 blocks leave a larger scene the most registers at that
// speed.
#ifndef SDF_LARGE
#define SDF_LARGE 0
#endif
#ifndef SDF_STORE
#define SDF_STORE 0
#endif
// The large-scene tier (raymarch_sums.cuh) keeps no running sums in the
// thread, and its replay of the march, a forward with little to overlap it,
// runs faster the more warps are in flight. Measured on an H100 with the
// 200-sphere union at 1920x1080x40 (tools/torch_kernel_probe.py --budgets),
// the image backward at 5 / 8 / 10 / 12 / 16 blocks an SM: 271.2 / 232.4 /
// 211.5 / 192.2 / 165.0 ms; the store-fed one, which replays nothing and
// holds at most 9 blocks for its shared ring: 107.3 / 103.0 / 112.2 / 111.9 /
// 126.1 ms.
constexpr int kBwdLargeMinBlocks = SDF_STORE ? 8 : 16;
constexpr int kBwdMinBlocks = SDF_LARGE ? kBwdLargeMinBlocks : 5;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kReduceThreads = 256;
// Rows of partials a block writes: one, or one per warp in the large-scene
// tier, whose warps add to their own rows.
constexpr int kRowsPerBlock = SDF_LARGE ? kBwdWarps : 1;

// Block sum of each of a thread's N running sums acc[0..N) into row[0..N):
// shuffles within a warp, then the warps' sums in order. Two rows of shared
// memory alternate, so one barrier per sum is enough. The loop is unrolled
// for a small N, so that every index is a constant and the array can live in
// registers. Every thread of the block must call it.
template <int N>
__device__ __forceinline__ void block_sum_to_row(const float* acc, float* __restrict__ row) {
  constexpr int kUnroll = N > 0 && N <= 96 ? N : 1;
  __shared__ float warp_sums[2][kBwdWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll kUnroll
  for (int j = 0; j < N; ++j) {
    float v = acc[j];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[j & 1][warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = warp_sums[j & 1][0];
      for (int w = 1; w < kBwdWarps; ++w) s += warp_sums[j & 1][w];
      row[j] = s;
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

// Blocks of `threads` threads of `kernel` that one SM of the current device
// holds at once, or a negative CUDA error.
template <typename Kernel>
static int resident_blocks(Kernel kernel, int threads) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks > 0 ? blocks : -static_cast<int>(cudaErrorLaunchOutOfResources);
}

// Rows of partials a launch of the pullback `kernel` over `count` pixels or
// rays writes (its grid size) on the current device: one block per
// kBwdThreads of them, at most one full wave. Or a negative CUDA error.
template <typename Kernel>
static int backward_grid_rows(Kernel kernel, int count) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int resident = resident_blocks(kernel, kBwdThreads);
  if (resident < 0) return resident;
  const int needed = (count + kBwdThreads - 1) / kBwdThreads;
  const int wave = sms * resident;
  return needed < wave ? needed : wave;
}
