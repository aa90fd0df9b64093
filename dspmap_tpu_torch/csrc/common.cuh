// Shared helpers of the port's CUDA kernels (built by dspmap_tpu_torch/kernels.py).
//
// Every entry point takes (ptrs, fparams, iparams, stream): host arrays of
// device pointers, float scalars and int scalars.  The host function copies
// what its kernel needs into a struct passed by value, launches on `stream`
// and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DSPMAP_API extern "C" __attribute__((visibility("default")))

// Round-to-nearest arithmetic without FMA contraction, so every kernel
// rounds at the same places as the plain PyTorch version of its function.
__device__ __forceinline__ float addf(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float subf(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mulf(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float divf(float a, float b) { return __fdiv_rn(a, b); }

template <typename T>
__host__ __forceinline__ T* dptr(const uint64_t* ptrs, int i) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(ptrs[i]));
}
