// The sum over pixels (or rays) that both backward kernels end in.
//
// The TPU kernel added every tile's scalars into one revisited output block,
// leaning on its grid running in order. Blocks here run in any order, so: a
// fixed grid (a multiple of the SM count) walks the work with a grid-stride
// loop; each thread keeps its accumulators across the loop; a block reduces
// them with warp shuffles and a shared-memory pass in a fixed order and
// writes one row of partials (block_sum_to_row); and reduce_partials_kernel
// sums the rows in a fixed order. No atomics: two launches on the same card
// give bit-identical sums.
#pragma once

#include <cuda_runtime.h>

constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kReduceThreads = 256;

// Block sum of each of a thread's N accumulators into row[0..N): shuffles
// within a warp, then the warps' sums in order. Two rows of shared memory
// alternate, so one barrier per accumulator is enough. The loop is unrolled
// for a small N, so that every index is a constant and the accumulators can
// live in registers. Every thread of the block must call it.
template <int N>
__device__ __forceinline__ void block_sum_to_row(const float* acc, float* __restrict__ row) {
  constexpr int kUnroll = N <= 96 ? N : 1;
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

// Rows of partials a backward launch over `count` pixels or rays writes (its
// grid size) on the current device, or a negative CUDA error.
static int backward_grid_rows(int count) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int needed = (count + kBwdThreads - 1) / kBwdThreads;
  const int fixed = sms * kBlocksPerSm;
  return needed < fixed ? needed : fixed;
}
