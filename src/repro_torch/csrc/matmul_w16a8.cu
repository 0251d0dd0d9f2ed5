// matmul_w16a8: exact int8 x int16 -> int32 by decomposed integer
// multiplication (DIM, the paper's §III-C): two int8 passes.
//
// Replaces: repro/kernels/dim_kernel.py:_dim_kernel (matmul_w16a8, the
// pallas_call at :74).  x [M, K] int8, w [K, N] int16 (row-major), out
// [M, N] int32, modulo 2^32 as the reference's int32 arithmetic wraps.
//
// Two routes, by M:
//
// decode (M <= 16) — bound by the int16 weight's 2·K·N bytes (8.4 MB at
//   K = N = 2048: 0.0025 ms at 3.35 TB/s): the route of int8_decode.cuh
//   (shared with matmul_int8 and matmul_int4_packed) with its Int16Bytes
//   loader.  The weight is read as the int8 [K, 2N] matrix of its bytes:
//   one 16-byte load holds 8 columns of a K row, and the int8 route's
//   __byte_perm transpose splits them in registers into each column's low
//   and high byte words.  The high byte is the arithmetic w >> 8 and goes
//   to the signed __dp4a; the low byte is taken unsigned, by the mixed-sign
//   dp4a.u32.s32, so that
//
//     x · w = 256·(x · hi) + x · lo         (lo = w & 0xFF, unsigned)
//
//   needs no row-sum correction.  Every partial sum is a uint32_t, and
//   everything after the two products is arithmetic modulo 2^32, so the
//   per-column sums of hi and lo (over lanes, warps and the cluster's K
//   splits, in any order) and their combination 256·hi + lo are exact
//   modulo 2^32: the reference's wrap.  K split over a thread-block
//   cluster, the splits summed in rank order through distributed shared
//   memory: one launch, no workspace, no atomics, deterministic.
//
// prefill (M > 16) — bound by the operations, counted as two int8 passes
//   (4·M·N·K): the tiled wmma GEMM of int8_tile.cuh on 64 x 64 tiles with
//   two B tiles.  With the centred low byte lo_c = (w & 0xFF) - 128 (in
//   [-128, 127], an int8 operand):
//
//     x · w = 256·(x · hi) + x · lo_c + 128·rowsum(x)
//
//   Each pass fits int32 for K < 131,072 (|x·hi| <= 128·128 per term); the
//   combination can leave int32, so the passes are combined in uint32_t
//   (signed overflow and left shifts of negative values are undefined in
//   C++) and the result reinterpreted.  Each thread loads 16 int16 columns
//   of one row and writes its hi and lo_c bytes into the two shared-memory
//   tiles, so the byte planes never exist in device memory; two
//   accumulator sets are combined per fragment element; the row sums of x
//   are taken once per block after the K loop, from the rows the block
//   already read.

#include "int8_decode.cuh"
#include "int8_tile.cuh"

namespace {

using namespace int8_tile;

// w[k0:k0+kBK, n0:n0+BN] int16 -> hi and lo_c tiles, each [BN/16][kBK][16].
template <int BN>
__device__ __forceinline__ void stage_b_dim(const int16_t* __restrict__ w, int n_cols, int k_dim,
                                            int n0, int k0, int vec, int8_t* bh_s, int8_t* bl_s) {
  constexpr int kGroups = BN / 16;
  for (int i = threadIdx.x; i < kBK * kGroups; i += kThreads) {
    const int kk = i / kGroups, cg = i % kGroups;
    const int gk = k0 + kk, gn = n0 + cg * 16;
    alignas(16) int16_t v[16] = {};
    if (gk < k_dim) {
      const int16_t* src = w + static_cast<size_t>(gk) * n_cols + gn;
      if (vec && gn + 16 <= n_cols) {
        reinterpret_cast<uint4*>(v)[0] = reinterpret_cast<const uint4*>(src)[0];
        reinterpret_cast<uint4*>(v)[1] = reinterpret_cast<const uint4*>(src)[1];
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = (gn + e < n_cols) ? src[e] : int16_t(0);
      }
    }
    alignas(16) int8_t hi[16];
    alignas(16) int8_t lo[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int u = static_cast<int>(static_cast<uint16_t>(v[e]));  // w mod 2^16
      hi[e] = static_cast<int8_t>((u >> 8) - ((u & 0x8000) >> 7));  // w >> 8, arithmetic
      lo[e] = static_cast<int8_t>((u & 0xFF) - 128);
    }
    *reinterpret_cast<uint4*>(b_row(bh_s, cg, kk)) = *reinterpret_cast<const uint4*>(hi);
    *reinterpret_cast<uint4*>(b_row(bl_s, cg, kk)) = *reinterpret_cast<const uint4*>(lo);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
matmul_w16a8_kernel(const int8_t* __restrict__ x, const int16_t* __restrict__ w,
                    int32_t* __restrict__ out, int m_rows, int n_cols, int k_dim, int vec_x,
                    int vec_w) {
  using T = Tile<BM, BN>;
  constexpr int kTiles = T::kABytes + 2 * T::kBBytes;
  constexpr int kSmem = kTiles > T::kTableBytes ? kTiles : T::kTableBytes;
  __shared__ __align__(256) unsigned char smem[kSmem];
  __shared__ int row_sum[BM];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);
  int8_t* bh_s = a_s + T::kABytes;
  int8_t* bl_s = bh_s + T::kBBytes;
  int* table = reinterpret_cast<int*>(smem);  // after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  AccFrag acc_hi[T::kFragsPerWarp], acc_lo[T::kFragsPerWarp];
  zero<BM, BN>(acc_hi);
  zero<BM, BN>(acc_lo);
  for (int k0 = 0; k0 < k_dim; k0 += kBK) {
    stage_a<BM>(x, m_rows, k_dim, m0, k0, vec_x, a_s);
    stage_b_dim<BN>(w, n_cols, k_dim, n0, k0, vec_w, bh_s, bl_s);
    __syncthreads();
    mma_stage<BM, BN>(a_s, bh_s, acc_hi, warp);
    mma_stage<BM, BN>(a_s, bl_s, acc_lo, warp);
    __syncthreads();
  }
  // 256·p_hi + p_lo per fragment element, modulo 2^32 (same layout: same shape).
#pragma unroll
  for (int f = 0; f < T::kFragsPerWarp; ++f) {
#pragma unroll
    for (int e = 0; e < acc_hi[f].num_elements; ++e) {
      const uint32_t v = (static_cast<uint32_t>(acc_hi[f].x[e]) << 8) +
                         static_cast<uint32_t>(acc_lo[f].x[e]);
      acc_hi[f].x[e] = static_cast<int>(v);
    }
  }
  store_acc<BM, BN>(acc_hi, table, warp);
  for (int r = warp; r < BM; r += kWarps) {  // rowsum(x), |sum| <= 128·K fits int32
    const int gm = m0 + r;
    int s = 0;
    if (gm < m_rows) {
      for (int k = lane; k < k_dim; k += 32) s += x[static_cast<size_t>(gm) * k_dim + k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) row_sum[r] = s;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < BM * BN; o += kThreads) {
    const int r = o / BN, c = o % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m_rows || gn >= n_cols) continue;
    const uint32_t v =
        static_cast<uint32_t>(table[r * BN + c]) + (static_cast<uint32_t>(row_sum[r]) << 7);
    out[static_cast<size_t>(gm) * n_cols + gn] = static_cast<int32_t>(v);
  }
}

template <int BM, int BN>
int launch(const void* x, const void* w, void* out, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (k % 16 == 0);
  const int vec_w = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (n % 8 == 0);
  matmul_w16a8_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int16_t*>(w),
      static_cast<int32_t*>(out), m, n, k, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int matmul_w16a8(const void* x, const void* w, void* out, int m, int n, int k,
                            void* stream) {
  if (m <= 0 || n <= 0 || n > (1 << 30) || k <= 0 || k >= 131072) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= 16)  // the weight as its int8 [K, 2N] bytes
    return int8_decode::matmul<int8_decode::Int16Bytes>(x, w, nullptr, nullptr, out, m, 2 * n,
                                                        k, 1, s);
  return launch<64, 64>(x, w, out, m, n, k, s);
}
