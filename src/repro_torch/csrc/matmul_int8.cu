// matmul_int8: W8A8, int8 x int8 -> exact int32, with the per-token and
// per-channel scales fused into the epilogue.
//
// Replaces: repro/kernels/gemv_int8.py:_matmul_int8_kernel and
// _matmul_int8_kernel_i32 (matmul_int8, the pallas_call at :81):
//
//   out[m, n] = (float(acc[m, n]) * x_scale[m]) * w_scale[n]    (out_int32 = 0)
//   out[m, n] = acc[m, n]                                       (out_int32 = 1)
//   acc[m, n] = sum_k x[m, k] * w[k, n]                          exact int32
//
// x [M, K] int8, w [K, N] int8 (row-major, as resident), x_scale [M] and
// w_scale [N] float32; out [M, N] float32 or int32.  The epilogue multiplies
// in the reference's order, in float32 with round-to-nearest, once on the
// whole integer sum, so the scaled output is the Pallas kernel's to the bit.
//
// Two routes, by M:
//
// decode (M <= 16) — bound by the int8 weight's K·N bytes (4.2 MB at wq:
//   0.0013 ms at 3.35 TB/s): the route of int8_decode.cuh (shared with
//   matmul_int4_packed) with its int8 loader.  K split over a thread-block
//   cluster, 16-byte weight loads issued before use, a __byte_perm
//   transpose into __dp4a (1.5 instructions a weight byte at M = 4;
//   per-byte integer multiply-adds take 5, and a build of them measured
//   1.2–1.8× slower at M = 4 and 16), partials in registers up to M = 4,
//   the splits summed in rank order through distributed shared memory.
//
// prefill (M > 16) — bound by the 2·M·N·K int8 operations: scaled_gemm_kernel
//   of int8_tile.cuh on 64 x 64 tiles.  Weights are staged as int8 straight
//   into the tensor cores, never widened, and the int32 accumulator lives in
//   wmma fragments across the whole K loop.

#include "int8_decode.cuh"
#include "int8_tile.cuh"

// Named (not anonymous): StageInt8 is a template argument of a __global__
// function template.
namespace matmul_int8_detail {

using namespace int8_tile;

// w[k0:k0+kBK, n0:n0+BN] int8 -> b_s [BN/16][kBK][16]; 16-byte loads when
// `vec` (w 16-byte aligned, N % 16 == 0) and the chunk is in bounds.
template <int BN>
struct StageInt8 {
  const int8_t* w;
  int n_cols, k_dim, vec;

  // the weight of group z of a grouped launch ([G, K, N] stacked)
  __device__ __forceinline__ StageInt8 group(int z) const {
    return {w + static_cast<size_t>(z) * k_dim * n_cols, n_cols, k_dim, vec};
  }

  __device__ __forceinline__ void operator()(int8_t* b_s, int n0, int k0) const {
    constexpr int kGroups = BN / 16;
    for (int i = threadIdx.x; i < kBK * kGroups; i += kThreads) {
      const int kk = i / kGroups, cg = i % kGroups;
      const int gk = k0 + kk, gn = n0 + cg * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < k_dim) {
        const int8_t* src = w + static_cast<size_t>(gk) * n_cols + gn;
        if (vec && gn + 16 <= n_cols) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          alignas(16) int8_t b[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) b[e] = (gn + e < n_cols) ? src[e] : int8_t(0);
          v = *reinterpret_cast<const uint4*>(b);
        }
      }
      *reinterpret_cast<uint4*>(b_row(b_s, cg, kk)) = v;
    }
  }
};

}  // namespace matmul_int8_detail

using matmul_int8_detail::StageInt8;

// groups = 1: one [M, K] x [K, N] product; groups = G: G of them stacked
// with their scales and outputs (the experts of a MoE layer), one launch.
extern "C" int matmul_int8(const void* x, const void* w, const void* x_scale,
                           const void* w_scale, void* out, int groups, int m, int n, int k,
                           int out_int32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto wp = static_cast<const int8_t*>(w);
  const int vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (n % 16 == 0);
  if (m <= 16)
    return int8_decode::matmul<int8_decode::Int8Rows>(x, w, x_scale, w_scale, out, m, n, k,
                                                       out_int32, s, groups);
  return int8_tile::launch_scaled_gemm<64, 64>(x, StageInt8<64>{wp, n, k, vec}, x_scale,
                                               w_scale, out, m, n, k, out_int32, s, groups);
}
