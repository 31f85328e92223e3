// The sums of the large-scene tier of the backward (raymarch_bwd.cuh).
//
// The small tier keeps a running sum per parameter slot in each thread. A
// scene of many slots cannot: its sums would sit in local memory, and each
// of its thousands of unit gradients with them. The large tier's adjoints
// (sdf/compile.py emit_large_vjp_cpp) add each leaf's cotangent to a row of
// sums the moment they have it, and skip the leaves whose cotangent is zero,
// which in a union is every primitive but the one a point is nearest to.
//
// On the card a row belongs to one warp (a row of the partials in device
// memory), and every add is a warp's: sdf_acc sums the 32 lanes' values with
// a fixed tree of shuffles, and lane 0 adds the total to the row, so a row's
// sum is taken in the same order in every launch and two launches give
// bit-identical gradients. The 32 lanes must all make the call: the large
// tier keeps a warp's lanes on one path through the pullback (a lane with
// nothing to add takes part with a zero), and every branch around a call is
// the warp's (sdf_any). A warp whose lanes all hold zero skips the tree.
// Measured on an H100, the 200-sphere union's image backward at
// 1920x1080x40 (tools/torch_kernel_probe.py --rows): these rows 163.56 ms;
// one row a block in shared memory, its warps adding with shared atomics
// (so in no fixed order: two launches differ) 164.60 ms; a row a warp in
// shared memory, 22.7 KB a block, which leaves 9 blocks an SM, 223.33 ms.
//
// A union of like children that the forward writes as a loop (sdf/compile.py
// UnionLoop) is pulled back as a loop too: one pass of a child's adjoint per
// distinct child of least distance among the warp's lanes, at a slot the
// warp shares, so that each slot takes the same lanes' values in the same
// order as from the straight-line sweep. A warp in which some lane's point
// has a tie or a NaN distance walks the tree of unions instead
// (sdf_tree_share, sdf_tree_colour), which gives each child the cotangent
// the straight-line sweep gives it, bit for bit.
//
// Compiled for the host (the CPU tests' g++ build), a "warp" is the one
// thread and the row is the thread's own sums.
//
// Included by the emitted large-tier adjoint, before the kernels' headers.
#pragma once

// The large tier's adjoints are functions of their own: one copy of each,
// however many call sites. On the card their forward reads the parameters
// from the uniforms by name (SDF_P), so that a parameter is an operand of the
// instruction that uses it, as in the kernels (raymarch_uniforms.cuh), and
// not a load; the few values a region of their reverse sweep recomputes read
// them through the pointer P (the same array), which keeps the compiler from
// taking the forward's values in their place.
#ifdef __CUDACC__
#include "raymarch_uniforms.cuh"
#define SDF_SPARSE __host__ __device__ __noinline__
#else
#define SDF_SPARSE __attribute__((noinline))
#endif
#ifdef __CUDA_ARCH__
#define SDF_P c_uniform
#else
#define SDF_P P
#endif

// Whether p holds on some lane of the warp.
__host__ __device__ __forceinline__ bool sdf_any(bool p) {
#ifdef __CUDA_ARCH__
  return __any_sync(0xffffffffu, p);
#else
  return p;
#endif
}

// Adds the warp's sum of v to row[slot]; every lane passes the same slot.
__host__ __device__ __forceinline__ void sdf_acc(float* row, int slot, float v) {
#ifdef __CUDA_ARCH__
  if (!__any_sync(0xffffffffu, v != 0.0f)) return;
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  if ((threadIdx.x & 31) == 0) atomicAdd(row + slot, v);
#else
  if (v != 0.0f) row[slot] += v;
#endif
}

// Adds each lane's v to row[its slot], lane by lane in order; a lane with a
// negative slot or a zero adds nothing. Lane 0 makes every add, so that
// the row's order is the same in every launch.
__host__ __device__ __forceinline__ void sdf_acc_at(float* row, int slot, float v) {
#ifdef __CUDA_ARCH__
  unsigned todo = __ballot_sync(0xffffffffu, slot >= 0 && v != 0.0f);
  while (todo != 0u) {
    const int lane = __ffs(todo) - 1;
    const float vl = __shfl_sync(0xffffffffu, v, lane);
    const int sl = __shfl_sync(0xffffffffu, slot, lane);
    if ((threadIdx.x & 31) == 0) atomicAdd(row + sl, vl);
    todo &= todo - 1u;
  }
#else
  if (slot >= 0 && v != 0.0f) row[slot] += v;
#endif
}

// The value v of the first lane of the warp where p holds; p holds on some
// lane, and every lane makes the call.
__host__ __device__ __forceinline__ int sdf_first(bool p, int v) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, v, __ffs(__ballot_sync(0xffffffffu, p)) - 1);
#else
  return v;
#endif
}

// Bit k of the bit set m (32 a word).
__host__ __device__ __forceinline__ bool sdf_bit(const unsigned* m, int k) {
  return (m[k >> 5] >> (k & 31)) & 1u;
}

// Whether the bit set m holds some / every one of lo, ..., hi - 1 (lo < hi).
__host__ __device__ inline bool sdf_bits_any(const unsigned* m, int lo, int hi) {
  for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
    unsigned want = ~0u;
    if (w == lo >> 5) want &= ~0u << (lo & 31);
    if (w == (hi - 1) >> 5) want &= ~0u >> (31 - ((hi - 1) & 31));
    if ((m[w] & want) != 0u) return true;
  }
  return false;
}

__host__ __device__ inline bool sdf_bits_all(const unsigned* m, int lo, int hi) {
  for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
    unsigned want = ~0u;
    if (w == lo >> 5) want &= ~0u << (lo & 31);
    if (w == (hi - 1) >> 5) want &= ~0u >> (31 - ((hi - 1) & 31));
    if ((m[w] & want) != want) return false;
  }
  return true;
}

// The tree of unions over n children: split[i] is the first child of the
// right side of the i-th Union in pre-order (its left side's Unions follow
// it, then its right side's). `least` marks the children whose distance
// equals the union's least, `nan` those whose distance is NaN: a side's
// least distance is the union's where it holds a child of `least`, NaN
// where every child is NaN, and greater otherwise. On the path from the top
// to a child of `least` or `nan` those are all the comparisons the tree
// makes, so both walks below give what its selects give.

// The cotangent the tree passes child k of the cotangent c of its distance:
// at each Union the min's rule (_pullback): all of it to the side whose
// least is less, half of it (0.5 * c) to the left and the rest (c - half)
// to the right where neither is less, the tree's own operations.
__host__ __device__ inline float sdf_tree_share(const int* split, int n, int k, float c,
                                                const unsigned* least, const unsigned* nan) {
  int lo = 0, hi = n, i = 0;
  while (hi - lo > 1 && c != 0.0f) {
    const int mid = split[i];
    const bool left = sdf_bits_any(least, lo, mid), right = sdf_bits_any(least, mid, hi);
    const bool lt = left && !right && !sdf_bits_all(nan, mid, hi);
    const bool gt = !left && right && !sdf_bits_all(nan, lo, mid);
    const float to_left = lt ? c : (gt ? 0.0f : 0.5f * c);
    if (k < mid) {
      c = to_left;
      hi = mid;
      i += 1;
    } else {
      c = c - to_left;
      i += mid - lo;
      lo = mid;
    }
  }
  return c;
}

// The child whose colour the tree gives (da < db ? a : b at each Union).
__host__ __device__ inline int sdf_tree_colour(const int* split, int n, const unsigned* least,
                                               const unsigned* nan) {
  int lo = 0, hi = n, i = 0;
  while (hi - lo > 1) {
    const int mid = split[i];
    if (sdf_bits_any(least, lo, mid) && !sdf_bits_any(least, mid, hi) &&
        !sdf_bits_all(nan, mid, hi)) {
      hi = mid;
      i += 1;
    } else {
      i += mid - lo;
      lo = mid;
    }
  }
  return lo;
}
