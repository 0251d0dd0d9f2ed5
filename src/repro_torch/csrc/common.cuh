// Shared by every kernel library in this directory.
//
// Each library exports plain C functions: raw device pointers, sizes and a
// cudaStream_t in, the launch's cudaError_t out (0 = launched).  The Python
// wrappers (repro_torch/kernels/*.py) check shapes, types, devices and
// contiguity before calling, and raise on a nonzero return.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// s_jk * 2^(j+k) for one plane pair: s_jk = -1 iff exactly one of j, k is 3
// (signed int4 two's complement), +1 otherwise or when unsigned.
__device__ __forceinline__ int plane_pair_weight(int j, int k, int is_signed) {
  const int w = 1 << (j + k);
  return (is_signed && ((j == 3) != (k == 3))) ? -w : w;
}

// Σ_jk s_jk·2^(j+k)·popcount(a_j & b_k) over one 32-element word.
__device__ __forceinline__ int bsdp_word(const uint32_t a[4], const uint32_t b[4],
                                         int is_signed) {
  int acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += plane_pair_weight(j, k, is_signed) * __popc(a[j] & b[k]);
    }
  }
  return acc;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
