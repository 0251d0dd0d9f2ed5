// bsdp_gemm_fused: the bit-plane GEMM as ONE contraction over
// plane-interleaved rows, for prefill and multi-slot decode (M > 1).
//
// Replaces: repro/kernels/bsdp_gemm.py:_bsdp_gemm_fused_kernel
// (bsdp_gemm_fused, the pallas_call at :197).  The planes of a tile are
// interleaved (row r·4+j holds plane j of row r) and one [M·4, K] × [K, N·4]
// contraction yields every plane-pair popcount sum; the [4, 4] s_jk·2^(j+k)
// weights then reduce the [M, 4, N, 4] pair table into int32.
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
//
// Bound by the weight planes' bytes at decode (N·4·Kw·4 B), like bsdp_gemm.
// Design (bsdp_mma.cuh, shared with bsdp_gemm): the contraction runs on the
// binary mma.sync m16n8k256 .b1 .and.popc straight on the plane words.  A
// rows are 4 tokens × 4 activation planes; the 8 B columns of a fragment are
// 2 weight columns × 4 weight planes, rows n·4 + k of wt viewed as [N·4, Kw]
// — the interleave is wt's memory layout, so each lane loads one plane row
// as it lies (16 bytes at a time) and one instruction yields the pair table
// of 4 tokens × 2 columns.  The epilogue weights it in int32 and adds the
// pairs held by neighbouring lanes (weight planes) and by lanes 16 apart
// (activation planes).  K split over a block's warps; 16 tokens a block on
// the grid's second axis above M = 4.

#include "bsdp_mma.cuh"

namespace {

template <int RT, int UMAX, bool VEC>
__global__ void __launch_bounds__(bsdp_mma::kThreads, 2)
bsdp_gemm_fused_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ wt,
                       int32_t* __restrict__ out, int m_rows, int n_cols, int kw,
                       int is_signed, int col_groups, int units_per_warp) {
  bsdp_mma::contract<true, RT, UMAX, VEC>(x, wt, out, m_rows, n_cols, kw, is_signed,
                                          col_groups, units_per_warp);
}

}  // namespace

// groups = 1: one [M, 4, Kw] x [N, 4, Kw] contraction; groups = G: G of them
// stacked (the experts of a MoE layer), one launch.
extern "C" int bsdp_gemm_fused(const void* x, const void* wt, void* out, int groups, int m,
                               int n, int kw, int is_signed, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return cudaErrorInvalidValue;
  if (m <= 4)
    return bsdp_mma::launch<1, 4>(bsdp_gemm_fused_kernel<1, 4, true>,
                                  bsdp_gemm_fused_kernel<1, 4, false>, x, wt, out, groups, m, n,
                                  kw, is_signed, stream);
  return bsdp_mma::launch<4, 1>(bsdp_gemm_fused_kernel<4, 1, true>,
                                bsdp_gemm_fused_kernel<4, 1, false>, x, wt, out, groups, m, n,
                                kw, is_signed, stream);
}
