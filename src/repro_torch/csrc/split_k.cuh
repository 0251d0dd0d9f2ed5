// Shared by bsdp_mma.cuh (bsdp_gemm, bsdp_gemm_fused) and int8_decode.cuh
// (matmul_int8, matmul_int4_packed): the SM count that their split choices
// read at run time.
#pragma once

#include <cuda_runtime.h>

namespace split_k {

// Streaming multiprocessors of the current device, queried once per device.
inline cudaError_t sm_count(int* count) {
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *count = counts[dev];
  return cudaSuccess;
}

}  // namespace split_k
