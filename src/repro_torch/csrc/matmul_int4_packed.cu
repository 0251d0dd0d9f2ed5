// matmul_int4_packed: W4A8 with two int4 weights per byte, unpacked in the
// kernel, int8 x int8 -> int32 on the tensor cores, scales fused.
//
// Replaces: repro/kernels/gemv_int4.py:_matmul_int4_kernel with _unpack_tile
// (matmul_int4_packed, the pallas_call at :76):
//
//   out[m, n] = (float(sum_k x[m, k] * w[k, n]) * x_scale[m]) * w_scale[n]
//
// x [M, K] int8 (K even), w_packed [K/2, N] int8: packed row r holds
// w[2r, n] in its low nibble and w[2r+1, n] in its high nibble, each a
// two's-complement int4.  x_scale [M], w_scale [N] float32; out [M, N] f32.
//
// Bound on the card: at decode the packed weight, K·N/2 bytes — half of
// W8A8's, which is the point of the format; at prefill the 2·M·N·K int8
// operations.  Design: scaled_gemm_kernel of int8_tile.cuh, with a weight
// stager that loads 16 packed bytes (16 columns of one packed row) per
// thread and writes the two unpacked, sign-extended int8 rows 2r and 2r+1
// into the shared-memory B tile, so the unpacked weight exists only in
// shared memory.  The decode grid is N/32 blocks, under the card's 132 SMs
// at N = 1024 and 2048.

#include "int8_tile.cuh"

// Named (not anonymous): StagePackedInt4 is a template argument of a
// __global__ function template.
namespace matmul_int4_detail {

using namespace int8_tile;

// Packed rows [k0/2, k0/2 + kBK/2) x columns [n0, n0+BN) -> the unpacked
// int8 tile b_s [BN/16][kBK][16].
template <int BN>
struct StagePackedInt4 {
  const int8_t* wp;
  int n_cols, k_half, vec;

  __device__ __forceinline__ void operator()(int8_t* b_s, int n0, int k0) const {
    constexpr int kGroups = BN / 16;
    for (int i = threadIdx.x; i < (kBK / 2) * kGroups; i += kThreads) {
      const int pr = i / kGroups, cg = i % kGroups;
      const int gr = k0 / 2 + pr, gn = n0 + cg * 16;
      alignas(16) int8_t packed[16] = {};
      if (gr < k_half) {
        const int8_t* src = wp + static_cast<size_t>(gr) * n_cols + gn;
        if (vec && gn + 16 <= n_cols) {
          *reinterpret_cast<uint4*>(packed) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) packed[e] = (gn + e < n_cols) ? src[e] : int8_t(0);
        }
      }
      alignas(16) int8_t lo[16];
      alignas(16) int8_t hi[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {  // nibble v in 0..15 is the int4 v - 16·(v >= 8)
        const unsigned u = static_cast<uint8_t>(packed[e]);
        lo[e] = static_cast<int8_t>(static_cast<int>(u & 0xFu) - static_cast<int>((u & 0x8u) << 1));
        hi[e] = static_cast<int8_t>(static_cast<int>(u >> 4) - static_cast<int>((u & 0x80u) >> 3));
      }
      *reinterpret_cast<uint4*>(b_row(b_s, cg, 2 * pr)) = *reinterpret_cast<const uint4*>(lo);
      *reinterpret_cast<uint4*>(b_row(b_s, cg, 2 * pr + 1)) = *reinterpret_cast<const uint4*>(hi);
    }
  }
};

}  // namespace matmul_int4_detail

using matmul_int4_detail::StagePackedInt4;

extern "C" int matmul_int4_packed(const void* x, const void* w_packed, const void* x_scale,
                                  const void* w_scale, void* out, int m, int n, int k,
                                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 2) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto wp = static_cast<const int8_t*>(w_packed);
  const int vec = (reinterpret_cast<uintptr_t>(w_packed) % 16 == 0) && (n % 16 == 0);
  if (m <= 16) {
    return int8_tile::launch_scaled_gemm<16, 32>(x, StagePackedInt4<32>{wp, n, k / 2, vec},
                                                 x_scale, w_scale, out, m, n, k, 0, s);
  }
  return int8_tile::launch_scaled_gemm<64, 64>(x, StagePackedInt4<64>{wp, n, k / 2, vec},
                                               x_scale, w_scale, out, m, n, k, 0, s);
}
