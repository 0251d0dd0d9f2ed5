// bsdp_gemv: bit-serial int4 dot products by AND + popcount (paper §IV,
// Algorithm 2) for the M == 1 request path.
//
// Replaces: repro/kernels/bsdp_kernel.py:_bsdp_kernel (bsdp_matmul, :67),
// the faithful UPMEM port, where lax.population_count plays UPMEM's `cao`.
//
//   out[m, n] = Σ_jk s_jk·2^(j+k)·Σ_w popcount(x[m, j, w] & wt[n, k, w])
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
//
// Bound on the card: device-memory bytes of the weight planes, N·4·Kw·4 B
// (12.6 MB for qwen3-1.7b's w_in) read once per call; the popcount work per
// byte is a few integer instructions, far below the card's integer rate.
// Design: the activation planes of one row (4·Kw words, ≤ 3 KB) are staged in
// shared memory once per block; each warp owns two output columns and its
// 32 lanes stride over the words of the column's four weight planes, so every
// warp-wide load is 128 contiguous bytes.  `__popc` on the 32-bit ANDs, the
// 16 plane pairs weighted into an int32 sum, then a warp shuffle reduce.
// The TPU kernel's sequential K grid axis becomes the lanes' loop over words.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kColsPerWarp = 2;

__global__ void __launch_bounds__(kWarps * 32)
bsdp_gemv_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ wt,
                 int32_t* __restrict__ out, int n_cols, int kw, int is_signed) {
  extern __shared__ uint32_t xs[];  // [4][kw] activation planes of row m
  const int m = blockIdx.y;
  const uint32_t* xr = x + static_cast<size_t>(m) * 4 * kw;
  for (int i = threadIdx.x; i < 4 * kw; i += blockDim.x) xs[i] = xr[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + warp) * kColsPerWarp;
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int n = n0 + c;
    if (n >= n_cols) break;  // uniform across the warp
    const uint32_t* wr = wt + static_cast<size_t>(n) * 4 * kw;
    int acc = 0;
    for (int i = lane; i < kw; i += 32) {
      const uint32_t a[4] = {xs[i], xs[kw + i], xs[2 * kw + i], xs[3 * kw + i]};
      const uint32_t b[4] = {__ldg(wr + i), __ldg(wr + kw + i),
                             __ldg(wr + 2 * kw + i), __ldg(wr + 3 * kw + i)};
      acc += bsdp_word(a, b, is_signed);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[static_cast<size_t>(m) * n_cols + n] = acc;
  }
}

}  // namespace

extern "C" int bsdp_gemv(const void* x, const void* wt, void* out, int m, int n,
                         int kw, int is_signed, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0 || m > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(4) * kw * sizeof(uint32_t);
  cudaError_t err = allow_smem(bsdp_gemv_kernel, smem);
  if (err != cudaSuccess) return err;
  const int cols_per_block = kWarps * kColsPerWarp;
  dim3 grid((n + cols_per_block - 1) / cols_per_block, m);
  bsdp_gemv_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(wt),
      static_cast<int32_t*>(out), n, kw, is_signed);
  return static_cast<int>(cudaGetLastError());
}
