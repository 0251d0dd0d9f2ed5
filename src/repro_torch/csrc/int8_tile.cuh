// The tiled int8 tensor-core GEMM of the prefill route (M > 16) shared by
// matmul_int8, matmul_int4_packed and matmul_w16a8: the three TPU kernels
// are one int8 x int8 -> int32 MXU contraction with different handling of
// the weight operand, so they share the activation staging and the wmma
// loop here.  W8A8 and W4A8 also share the whole kernel (scaled_gemm_kernel),
// each passing the functor that stages its weight tile; DIM, with two
// weight tiles and its own epilogue, writes its kernel from the pieces.  The
// decode route (M <= 16) of all three is int8_decode.cuh.
//
// A block owns a BM x BN output tile and walks K in stages of kBK = 128
// inside the block (the TPU grid's sequential K axis: nothing carries
// between blocks).  Per stage the activation tile x[m0:m0+BM, k0:k0+128] and
// the int8 weight tile [128, BN] are staged in shared memory, zero-padded at
// the ragged M, N and K edges (zeros are exact for every integer path), and
// the 8 warps run nvcuda::wmma s8 m16n16k16 into int32 accumulator fragments.
//
// Shared-memory layouts keep every wmma tile pointer 256-bit aligned with
// ldm = 16 bytes (the wmma rule for 8-bit operands):
//   A  [kKSub][BM][16]       16-byte k-slices of BM rows   (matrix_a row_major)
//   B  [BN/16][kBK][16]      16-column groups of kBK rows  (matrix_b row_major)
//
// Warps: each of the 8 warps owns kFrags/8 of the tile's output fragments
// over the whole K.
//
// Grouped launch (the experts of a MoE layer, matmul_int8): the grid's
// third axis walks `groups` independent products of the same shape,
// stacked in memory — x [G, M, K], x_scale [G, M], w_scale [G, N], out
// [G, M, N], and the weight, which the staging functor's `group(z)` offsets.

#pragma once

#include <mma.h>

#include "common.cuh"

namespace int8_tile {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 128;         // K elements per stage
constexpr int kKSub = kBK / 16;  // wmma k-slices per stage

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

template <int BM, int BN>
struct Tile {
  static constexpr int kColFrags = BN / 16;
  static constexpr int kFrags = (BM / 16) * kColFrags;
  static constexpr int kFragsPerWarp = kFrags / kWarps;
  static constexpr int kABytes = BM * kBK;
  static constexpr int kBBytes = kBK * BN;
  static constexpr int kTableBytes = BM * BN * 4;  // int32 sums
  static_assert(BM % 16 == 0 && BN % 16 == 0, "whole fragments");
  static_assert(kFragsPerWarp * kWarps == kFrags, "warps cover the tile");
};

// x[m0:m0+BM, k0:k0+kBK] int8 -> a_s [kKSub][BM][16]; 16-byte loads when
// `vec` (x 16-byte aligned, K % 16 == 0) and the chunk is in bounds.
template <int BM>
__device__ __forceinline__ void stage_a(const int8_t* __restrict__ x, int m_rows, int k_dim,
                                        int m0, int k0, int vec, int8_t* a_s) {
  for (int i = threadIdx.x; i < BM * kKSub; i += kThreads) {
    const int r = i / kKSub, ks = i % kKSub;
    const int gm = m0 + r, gk = k0 + ks * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gm < m_rows) {
      const int8_t* src = x + static_cast<size_t>(gm) * k_dim + gk;
      if (vec && gk + 16 <= k_dim) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        alignas(16) int8_t b[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) b[e] = (gk + e < k_dim) ? src[e] : int8_t(0);
        v = *reinterpret_cast<const uint4*>(b);
      }
    }
    *reinterpret_cast<uint4*>(a_s + (ks * BM + r) * 16) = v;
  }
}

// Where row kk of column group cg of a B tile lives in shared memory.
__device__ __forceinline__ int8_t* b_row(int8_t* b_s, int cg, int kk) {
  return b_s + (cg * kBK + kk) * 16;
}

// One stage's contraction: acc += a_s · b_s on this warp's fragments.
template <int BM, int BN>
__device__ __forceinline__ void mma_stage(const int8_t* a_s, const int8_t* b_s,
                                          AccFrag (&acc)[Tile<BM, BN>::kFragsPerWarp],
                                          int warp) {
  using T = Tile<BM, BN>;
  const int f0 = warp * T::kFragsPerWarp;
#pragma unroll
  for (int ks = 0; ks < kKSub; ++ks) {
#pragma unroll
    for (int f = 0; f < T::kFragsPerWarp; ++f) {
      const int rf = (f0 + f) / T::kColFrags, cf = (f0 + f) % T::kColFrags;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
      wmma::load_matrix_sync(a, a_s + (ks * BM + rf * 16) * 16, 16);
      wmma::load_matrix_sync(b, b_s + (cf * kBK + ks * 16) * 16, 16);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
}

// Each warp's fragments -> table [BM][BN] int32.
template <int BM, int BN>
__device__ __forceinline__ void store_acc(AccFrag (&acc)[Tile<BM, BN>::kFragsPerWarp],
                                          int* table, int warp) {
  using T = Tile<BM, BN>;
  const int f0 = warp * T::kFragsPerWarp;
#pragma unroll
  for (int f = 0; f < T::kFragsPerWarp; ++f) {
    const int rf = (f0 + f) / T::kColFrags, cf = (f0 + f) % T::kColFrags;
    wmma::store_matrix_sync(table + rf * 16 * BN + cf * 16, acc[f], BN, wmma::mem_row_major);
  }
}

template <int BM, int BN>
__device__ __forceinline__ void zero(AccFrag (&acc)[Tile<BM, BN>::kFragsPerWarp]) {
#pragma unroll
  for (int f = 0; f < Tile<BM, BN>::kFragsPerWarp; ++f) wmma::fill_fragment(acc[f], 0);
}

// The W8A8 / W4A8 kernel: out = (float(x·w) * x_scale[m]) * w_scale[n] in
// the reference's order with round-to-nearest (bit-identical to the plain
// versions), or the raw int32 sums when out_int32.  `stage_b(b_s, n0, k0)`
// writes the int8 weight tile w[k0:k0+kBK, n0:n0+BN] into b_s, zero-padded;
// `stage_b.group(z)` is the functor of group z's weight.
template <int BM, int BN, typename StageB>
__global__ void __launch_bounds__(kThreads)
scaled_gemm_kernel(const int8_t* __restrict__ x, StageB stage_b,
                   const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                   void* __restrict__ out, int m_rows, int n_cols, int k_dim, int vec_x,
                   int out_int32) {
  using T = Tile<BM, BN>;
  const size_t z = blockIdx.z;  // this block's group of a grouped launch
  x += z * m_rows * k_dim;
  x_scale += z * m_rows;
  w_scale += z * n_cols;
  out = static_cast<char*>(out) + z * m_rows * n_cols * sizeof(int32_t);
  const StageB stage_w = stage_b.group(blockIdx.z);
  constexpr int kSmem = T::kABytes + T::kBBytes > T::kTableBytes
                            ? T::kABytes + T::kBBytes : T::kTableBytes;
  __shared__ __align__(256) unsigned char smem[kSmem];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);
  int8_t* b_s = a_s + T::kABytes;
  int* table = reinterpret_cast<int*>(smem);  // after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  AccFrag acc[T::kFragsPerWarp];
  zero<BM, BN>(acc);
  for (int k0 = 0; k0 < k_dim; k0 += kBK) {
    stage_a<BM>(x, m_rows, k_dim, m0, k0, vec_x, a_s);
    stage_w(b_s, n0, k0);
    __syncthreads();
    mma_stage<BM, BN>(a_s, b_s, acc, warp);
    __syncthreads();
  }
  store_acc<BM, BN>(acc, table, warp);
  __syncthreads();
  for (int o = threadIdx.x; o < BM * BN; o += kThreads) {
    const int r = o / BN, c = o % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m_rows || gn >= n_cols) continue;
    const int s = table[r * BN + c];
    const size_t at = static_cast<size_t>(gm) * n_cols + gn;
    if (out_int32) {
      static_cast<int32_t*>(out)[at] = s;
    } else {
      static_cast<float*>(out)[at] =
          __fmul_rn(__fmul_rn(__int2float_rn(s), x_scale[gm]), w_scale[gn]);
    }
  }
}

// Launch scaled_gemm_kernel on a BM x BN tile grid over `groups` stacked
// products; returns the launch's cudaError_t.  Both callers take 64 x 64
// tiles.
template <int BM, int BN, typename StageB>
int launch_scaled_gemm(const void* x, StageB stage_b, const void* x_scale, const void* w_scale,
                       void* out, int m, int n, int k, int out_int32, cudaStream_t stream,
                       int groups = 1) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, groups);
  if (grid.y > 65535 || groups <= 0 || groups > 65535) return cudaErrorInvalidValue;
  const int vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (k % 16 == 0);
  scaled_gemm_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), stage_b, static_cast<const float*>(x_scale),
      static_cast<const float*>(w_scale), out, m, n, k, vec_x, out_int32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8_tile
