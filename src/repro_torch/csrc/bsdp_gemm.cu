// bsdp_gemm: the unrolled bit-plane GEMM, one int32 sum per plane pair.
//
// Replaces: repro/kernels/bsdp_gemm.py:_bsdp_gemm_kernel (bsdp_gemm, the
// pallas_call at :242).  Algorithm 2 over a batch of rows:
//
//   out[m, n] = sum_{j,k} s_jk · 2^(j+k) · popcount(x_j[m] AND w_k[n])
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
// This is the "unfused rung" that bsdp_gemm_fused is measured against: each
// of the 16 plane pairs is its own contraction, weighted in int32 after it.
//
// Bound by the weight planes' bytes at decode.  Design (bsdp_mma.cuh, shared
// with bsdp_gemm_fused): the plane words go packed into the binary mma.sync
// m16n8k256 .b1 .and.popc, rows = 4 tokens × 4 activation planes, one chain
// per weight plane over 8 weight columns of a warp, K split over a block's
// warps; 16 tokens a block on the grid's second axis above M = 4.

#include "bsdp_mma.cuh"

namespace {

template <int RT, int UMAX, bool VEC>
__global__ void __launch_bounds__(bsdp_mma::kThreads, 2)
bsdp_gemm_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ wt,
                 int32_t* __restrict__ out, int m_rows, int n_cols, int kw, int is_signed,
                 int col_groups, int units_per_warp) {
  bsdp_mma::contract<false, RT, UMAX, VEC>(x, wt, out, m_rows, n_cols, kw, is_signed,
                                           col_groups, units_per_warp);
}

}  // namespace

// groups = 1: one [M, 4, Kw] x [N, 4, Kw] contraction; groups = G: G of them
// stacked (the experts of a MoE layer), one launch.
extern "C" int bsdp_gemm(const void* x, const void* wt, void* out, int groups, int m,
                         int n, int kw, int is_signed, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0) return cudaErrorInvalidValue;
  if (m <= 4)
    return bsdp_mma::launch<1, 4>(bsdp_gemm_kernel<1, 4, true>,
                                  bsdp_gemm_kernel<1, 4, false>, x, wt, out, groups, m, n, kw,
                                  is_signed, stream);
  return bsdp_mma::launch<4, 1>(bsdp_gemm_kernel<4, 1, true>, bsdp_gemm_kernel<4, 1, false>,
                                x, wt, out, groups, m, n, kw, is_signed, stream);
}
