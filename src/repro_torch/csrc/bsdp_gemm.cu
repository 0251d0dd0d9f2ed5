// bsdp_gemm: the unrolled bit-plane GEMM — 16 per-plane-pair 0/1 int8
// tensor-core contractions per K tile, each weighted into an int32 sum.
//
// Replaces: repro/kernels/bsdp_gemm.py:_bsdp_gemm_kernel (bsdp_gemm, the
// pallas_call at :242).  For 0/1 bit vectors popcount(a AND b) == a · b, so
// every (j, k) plane-pair pass of Algorithm 2 over a batch of rows is a 0/1
// int8 matmul:
//
//   out[m, n] = sum_{j,k} s_jk · 2^(j+k) · (xbits_j · wbits_k^T)[m, n]
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
// This is the "unfused rung" that bsdp_gemm_fused is measured against: the
// same tile (16 x 32 outputs, 128 elements of K per step) and the same
// unpack, but per K tile each of the 16 plane pairs gets its own wmma
// contraction into a fresh int32 fragment, and that fragment is weighted by
// s_jk·2^(j+k) into the accumulator (accumulator fragments of one shape share
// a layout, so the elementwise update is legal).  Bit-identical to the fused
// form: both are exact integer sums.
//
// Bound on the card: at decode (M = slots) the weight planes, N·4·Kw·4 B; at
// prefill the 16·M·N·K 0/1 int8 operations.  Design: the K loop runs inside
// the block; the four planes of each tile are unpacked into separate 0/1
// int8 bit tiles in shared memory, stored as 16-byte k-slices so every wmma
// tile pointer is 256-bit aligned.  Warp w owns column tile w & 1 and
// activation plane j = w >> 1, so it runs that plane's four pairs (j, 0..3)
// and reuses each loaded activation fragment four times; the four planes'
// sums are added in the epilogue.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kBM = 16;          // output rows per block
constexpr int kBN = 32;          // output columns per block
constexpr int kBKW = 4;          // plane words per K step (128 elements)
constexpr int kKSub = kBKW * 2;  // 16-element k slices per K step
constexpr int kThreads = 256;    // 8 warps: 2 column tiles x 4 activation planes
constexpr int kABytes = 4 * kKSub * kBM * 16;  // a_bits [plane][kslice][row][16]
constexpr int kBBytes = 4 * kKSub * kBN * 16;  // b_bits [plane][kslice][col][16]
constexpr int kSmem = kABytes + kBBytes;       // the [4][kBM][kBN] int32 table aliases it

static_assert(4 * kBM * kBN * 4 <= kSmem, "the plane table fits under the bit tiles");
static_assert(kBM * 4 * kBKW == kThreads, "one activation word per thread");

__global__ void __launch_bounds__(kThreads)
bsdp_gemm_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ wt,
                 int32_t* __restrict__ out, int m_rows, int n_cols, int kw, int is_signed) {
  __shared__ __align__(256) unsigned char smem[kSmem];
  int8_t* a_bits = reinterpret_cast<int8_t*>(smem);
  int8_t* b_bits = reinterpret_cast<int8_t*>(smem + kABytes);
  int* table = reinterpret_cast<int*>(smem);  // after the K loop

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int col_tile = warp & 1;
  const int j = warp >> 1;  // this warp's activation plane

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
  wmma::fill_fragment(acc, 0);

  for (int kw0 = 0; kw0 < kw; kw0 += kBKW) {
    {  // activation planes: kBM rows x 4 planes x kBKW words, one per thread
      const int t = threadIdx.x;
      const int r = t / (4 * kBKW), p = (t / kBKW) % 4, wi = t % kBKW;
      const int gm = m0 + r, gk = kw0 + wi;
      const uint32_t word =
          (gm < m_rows && gk < kw) ? x[(static_cast<size_t>(gm) * 4 + p) * kw + gk] : 0u;
      expand_word(word, a_bits + ((p * kKSub + 2 * wi) * kBM + r) * 16,
                  a_bits + ((p * kKSub + 2 * wi + 1) * kBM + r) * 16);
    }
    for (int t = threadIdx.x; t < kBN * 4 * kBKW; t += kThreads) {  // weight planes
      const int c = t / (4 * kBKW), p = (t / kBKW) % 4, wi = t % kBKW;
      const int gn = n0 + c, gk = kw0 + wi;
      const uint32_t word =
          (gn < n_cols && gk < kw) ? wt[(static_cast<size_t>(gn) * 4 + p) * kw + gk] : 0u;
      expand_word(word, b_bits + ((p * kKSub + 2 * wi) * kBN + c) * 16,
                  b_bits + ((p * kKSub + 2 * wi + 1) * kBN + c) * 16);
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> pair[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) wmma::fill_fragment(pair[k], 0);
#pragma unroll
    for (int ks = 0; ks < kKSub; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_bits + ((j * kKSub + ks) * kBM) * 16, 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(b, b_bits + ((k * kKSub + ks) * kBN + col_tile * 16) * 16, 16);
        wmma::mma_sync(pair[k], a, b, pair[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int wjk = plane_pair_weight(j, k, is_signed);
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] += wjk * pair[k].x[e];
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(table + (j * kBM) * kBN + col_tile * 16, acc, kBN,
                          wmma::mem_row_major);
  __syncthreads();
  for (int o = threadIdx.x; o < kBM * kBN; o += kThreads) {
    const int r = o / kBN, c = o % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m_rows || gn >= n_cols) continue;
    int s = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) s += table[(p * kBM + r) * kBN + c];
    out[static_cast<size_t>(gm) * n_cols + gn] = s;
  }
}

}  // namespace

extern "C" int bsdp_gemm(const void* x, const void* wt, void* out, int m, int n, int kw,
                         int is_signed, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return cudaErrorInvalidValue;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  bsdp_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(wt),
      static_cast<int32_t*>(out), m, n, kw, is_signed);
  return static_cast<int>(cudaGetLastError());
}
