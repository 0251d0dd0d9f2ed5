// bsdp_gemm_fused: the bit-plane GEMM as ONE int8 tensor-core contraction
// per tile, for prefill and multi-slot decode (M > 1).
//
// Replaces: repro/kernels/bsdp_gemm.py:_bsdp_gemm_fused_kernel
// (bsdp_gemm_fused, :163).  For 0/1 bit vectors popcount(a AND b) == a · b,
// so the planes of a tile are unpacked into plane-interleaved 0/1 int8 rows
// (row r·4+j holds plane j of row r) and one [BM·4, K] × [K, BN·4] int8
// contraction yields every plane-pair popcount sum; the [4, 4]
// s_jk·2^(j+k) weights then reduce the [BM, 4, BN, 4] pair table into int32.
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
//
// Bound on the card: at decode (M = slots = 4) the weight planes, N·4·Kw·4 B
// read from device memory; at prefill (M in the hundreds) the contraction,
// 16·M·N·K int8 multiply-adds on the tensor cores (the plane interleave
// costs 16× the int4 dot product's work).  Design: threads own disjoint
// output tiles; the K loop runs inside the block (the TPU grid's sequential
// K axis) with the int32 pair table in wmma accumulator fragments, so no
// carry crosses blocks.  The unpacked bit tiles live only in shared memory,
// stored as 16-byte k-slices so every wmma tile pointer is 256-bit aligned.
// wgmma and TMA are left for a later change: this is the simple form.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kBM = 16;             // output rows per block
constexpr int kBN = 32;             // output columns per block
constexpr int kBKW = 4;             // plane words per K step (128 elements)
constexpr int kKSub = kBKW * 2;     // 16-element k slices per K step
constexpr int kAR = kBM * 4;        // interleaved activation rows (64)
constexpr int kBR = kBN * 4;        // interleaved weight rows (128)
constexpr int kThreads = 256;       // 8 warps: 4 row tiles × 2 halves of 8 column tiles
constexpr int kSmem = kAR * kBR * 4;  // int32 pair table; aliases the bit tiles

static_assert(kKSub * (kAR + kBR) * 16 <= kSmem, "bit tiles must fit under the table");
static_assert(kBM * 4 * kBKW == kThreads, "one activation word per thread");

__global__ void __launch_bounds__(kThreads)
bsdp_gemm_fused_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ wt,
                       int32_t* __restrict__ out, int m_rows, int n_cols, int kw,
                       int is_signed) {
  __shared__ __align__(256) unsigned char smem[kSmem];
  int8_t* a_bits = reinterpret_cast<int8_t*>(smem);                     // [kKSub][kAR][16]
  int8_t* b_bits = reinterpret_cast<int8_t*>(smem + kKSub * kAR * 16);  // [kKSub][kBR][16]
  int* table = reinterpret_cast<int*>(smem);                             // [kAR][kBR]

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int row_tile = warp >> 1;       // 0..3
  const int col_tile0 = (warp & 1) * 4;  // 0 or 4

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0);

  for (int kw0 = 0; kw0 < kw; kw0 += kBKW) {
    {  // activation tile: kBM rows × 4 planes × kBKW words, one per thread
      const int t = threadIdx.x;
      const int r = t / (4 * kBKW), j = (t / kBKW) % 4, wi = t % kBKW;
      const int gm = m0 + r, gk = kw0 + wi;
      const uint32_t word =
          (gm < m_rows && gk < kw) ? x[(static_cast<size_t>(gm) * 4 + j) * kw + gk] : 0u;
      const int row = r * 4 + j;
      expand_word(word, a_bits + ((2 * wi) * kAR + row) * 16,
                  a_bits + ((2 * wi + 1) * kAR + row) * 16);
    }
    for (int t = threadIdx.x; t < kBN * 4 * kBKW; t += kThreads) {  // weight tile
      const int c = t / (4 * kBKW), k = (t / kBKW) % 4, wi = t % kBKW;
      const int gn = n0 + c, gk = kw0 + wi;
      const uint32_t word =
          (gn < n_cols && gk < kw) ? wt[(static_cast<size_t>(gn) * 4 + k) * kw + gk] : 0u;
      const int row = c * 4 + k;
      expand_word(word, b_bits + ((2 * wi) * kBR + row) * 16,
                  b_bits + ((2 * wi + 1) * kBR + row) * 16);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKSub; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_bits + (ks * kAR + row_tile * 16) * 16, 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(b, b_bits + (ks * kBR + (col_tile0 + i) * 16) * 16, 16);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::store_matrix_sync(table + (row_tile * 16) * kBR + (col_tile0 + i) * 16, acc[i],
                            kBR, wmma::mem_row_major);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kBM * kBN; o += kThreads) {
    const int r = o / kBN, c = o % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m_rows || gn >= n_cols) continue;
    int s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s += plane_pair_weight(j, k, is_signed) * table[(r * 4 + j) * kBR + c * 4 + k];
      }
    }
    out[static_cast<size_t>(gm) * n_cols + gn] = s;
  }
}

}  // namespace

extern "C" int bsdp_gemm_fused(const void* x, const void* wt, void* out, int m, int n,
                               int kw, int is_signed, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return cudaErrorInvalidValue;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  bsdp_gemm_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(wt),
      static_cast<int32_t*>(out), m, n, kw, is_signed);
  return static_cast<int>(cudaGetLastError());
}
