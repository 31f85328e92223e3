// The uniforms of a launch: the flat scene parameters and, for the image
// kernels, the 19 view scalars behind them.
//
// Every thread of every kernel here reads the same few dozen scalars. Read
// through a pointer into device memory they are loaded into registers and
// held there, or loaded again inside the march loop where registers are
// short; read from constant memory they are operands of the instructions
// that use them. Measured on an H100 with SphereRepeat at 1920x1080x40
// the image forward 0.2905 -> 0.2678 ms (its
// march loop 93 -> 88 instructions and no load, 40 -> 32 registers), the image
// backward 1.4476 -> 1.3841 ms, the copies included.
//
// The constant bank holds 64 KB, 16,384 floats. A scene whose parameters and
// view do not fit there (more than 16,365 slots, such as a palette of
// thousands of rows) keeps the same array in device memory instead, where
// the kernels load what they read: the same code, without the bank's limit.
// The build needs to know nothing of it, and no scene is refused.
//
// The array is one buffer per library, that is per scene structure and kernel
// family, on each card: every card the library launches on holds its own copy
// of the library's module. Each launch copies its parameters and view into it on its stream
// (device to device, no synchronisation, no host copy: the parameters live on
// the card) ahead of its kernel, so launches on one stream, PyTorch's
// default, are ordered. Two streams that launch through one library would
// overwrite each other's uniforms between copy and kernel, so the wrappers
// (render/cuda/raymarch_kernel.py) make a launch on another stream than the
// library's last on the same card wait for that one with an event; a caller
// of the C entry points must do the same. The copy, the kernel and the
// backward's sizing run on the calling thread's current card (the wrappers
// make it the tensors' card).
//
// The including translation unit defines SDF_N_PARAMS first.
#pragma once

#include <cuda_runtime.h>

#define SDF_VIEW_SCALARS 19
#define SDF_CONSTANT_FLOATS (64 * 1024 / 4)
constexpr int kViewScalars = SDF_VIEW_SCALARS;
// The scene parameters, then the view scalars.
#if SDF_N_PARAMS + SDF_VIEW_SCALARS <= SDF_CONSTANT_FLOATS
__constant__ float c_uniform[SDF_N_PARAMS + kViewScalars];
#else
__device__ float c_uniform[SDF_N_PARAMS + kViewScalars];
#endif

// The parameters the scene's functions read: the array above, or where the
// emitted program defines SDF_SHARED_PARAMS (sdf/compile.py: a program whose
// unions of like children are loops) a copy of its parameters in shared
// memory, made once a block. A loop reads child k's slots with an index that
// changes every child, and from the constant bank that was the frame's
// bottleneck: measured on an H100 with the 200-sphere union (1,400 slots) at
// 1920x1080x40, the image forward 34.83 ms reading the constant bank, 13.75
// ms the shared copy (the straight-line program 35.92); the image backward
// 114.48 / 108.71 ms. A straight-line program reads each parameter as an
// operand of the instruction that uses it, and keeps the bank. Every thread
// of the block calls this, before any of them returns.
#ifndef SDF_SHARED_PARAMS
#define SDF_SHARED_PARAMS 0
#endif
__device__ __forceinline__ const float* scene_params() {
#if SDF_SHARED_PARAMS
  __shared__ float shared_params[SDF_N_PARAMS];
  for (int j = threadIdx.x; j < SDF_N_PARAMS; j += blockDim.x) shared_params[j] = c_uniform[j];
  __syncthreads();
  return shared_params;
#else
  return c_uniform;
#endif
}

// Copies the launch's uniforms into the library's array on `stream`, ahead of
// its kernel; `view19` is null for a kernel that takes its rays as arrays.
static cudaError_t copy_uniforms(const float* params, const float* view19, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (SDF_N_PARAMS > 0) {
    err = cudaMemcpyToSymbolAsync(c_uniform, params, SDF_N_PARAMS * sizeof(float), 0,
                                  cudaMemcpyDeviceToDevice, stream);
  }
  if (err == cudaSuccess && view19 != nullptr) {
    err = cudaMemcpyToSymbolAsync(c_uniform, view19, kViewScalars * sizeof(float),
                                  SDF_N_PARAMS * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  }
  return err;
}
