// matmul_int4_packed: W4A8 with two int4 weights per byte, unpacked in the
// kernel, int8 x int8 -> exact int32, scales fused.
//
// Replaces: repro/kernels/gemv_int4.py:_matmul_int4_kernel with _unpack_tile
// (matmul_int4_packed, the pallas_call at :76):
//
//   out[m, n] = (float(sum_k x[m, k] * w[k, n]) * x_scale[m]) * w_scale[n]
//
// x [M, K] int8 (K even), w_packed [K/2, N] int8: packed row r holds
// w[2r, n] in its low nibble and w[2r+1, n] in its high nibble, each a
// two's-complement int4.  x_scale [M], w_scale [N] float32; out [M, N] f32.
// The epilogue multiplies in the reference's order, in float32 with
// round-to-nearest, once on the whole integer sum.
//
// Two routes, by M:
//
// decode (M <= 16) — bound by the packed weight, K·N/2 bytes (2.1 MB at wq:
//   0.0006 ms at 3.35 TB/s), half of W8A8's, which is the point of the
//   format.  The route of int8_decode.cuh (shared with matmul_int8) with the
//   packed loader below: K split over a thread-block cluster, counted in
//   chunks of loads (so in packed bytes); a thread's unit is 4 16-byte loads
//   of packed rows r .. r+3 = K rows 2r .. 2r+7 of 16 columns, as many bytes
//   in flight as the int8 route's.  In registers each load's nibbles are
//   sign-extended per byte into its two K rows, two loads make one quad of
//   4 K rows, and the quad goes through the int8 route's __byte_perm
//   transpose into __dp4a.  Partials in registers up to M = 4, the splits
//   summed in rank order through distributed shared memory.  The unpacked
//   weight exists only in registers.
//
// prefill (M > 16) — bound by the 2·M·N·K int8 operations: scaled_gemm_kernel
//   of int8_tile.cuh on 64 x 64 tiles, with a weight stager that loads 16
//   packed bytes (16 columns of one packed row) per thread and writes the
//   two unpacked, sign-extended int8 rows 2r and 2r+1 into the shared-memory
//   B tile.

#include "int8_decode.cuh"
#include "int8_tile.cuh"

// Named (not anonymous): both structs are template arguments of a __global__
// function template.
namespace matmul_int4_detail {

using namespace int8_tile;

// The four low (sh = 0) or high (sh = 4) nibbles of v, each sign-extended
// into its byte: n + 0x78 sets bit 7 exactly when n >= 8 (no carry leaves
// the byte), and the xor with 0x78 then gives n below 8 and n - 16 (two's
// complement) from 8 up.
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int sh) {
  return (((v >> sh) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x78787878u;
}

// The decode loader: a unit is packed rows k/2 .. k/2+3, i.e. K rows k .. k+7
// (k even), two quads of 4 K rows.
struct PackedInt4Rows {
  static constexpr int kQuads = 2;
  static constexpr bool kDim = false;

  template <bool VEC>
  static __device__ __forceinline__ void load(uint4 (&raw)[4], const int8_t* __restrict__ wp,
                                              int k, int k_end, int n, int n_cols) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pr = k / 2 + r;
      raw[r] = int8_decode::load_w16<VEC>(wp, pr, 2 * pr < k_end, n, n_cols);
    }
  }

  // quad qq: K rows k + 4qq .. +3 = the low and high nibbles of packed rows
  // 2qq and 2qq + 1 of the unit
  static __device__ __forceinline__ void quad(const uint4 (&raw)[4], int qq,
                                              uint32_t (&col)[16]) {
    const uint4 p = raw[2 * qq], q = raw[2 * qq + 1];
    const uint32_t a[4] = {p.x, p.y, p.z, p.w};
    const uint32_t b[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      int8_decode::transpose4(nibbles(a[e], 0), nibbles(a[e], 4), nibbles(b[e], 0),
                              nibbles(b[e], 4), col + 4 * e);
  }
};

// Packed rows [k0/2, k0/2 + kBK/2) x columns [n0, n0+BN) -> the unpacked
// int8 tile b_s [BN/16][kBK][16].
template <int BN>
struct StagePackedInt4 {
  const int8_t* wp;
  int n_cols, k_half, vec;

  // the weight of group z of a grouped launch ([G, K/2, N] stacked)
  __device__ __forceinline__ StagePackedInt4 group(int z) const {
    return {wp + static_cast<size_t>(z) * k_half * n_cols, n_cols, k_half, vec};
  }

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

extern "C" int matmul_int4_packed(const void* x, const void* w_packed, const void* x_scale,
                                  const void* w_scale, void* out, int m, int n, int k,
                                  void* stream) {
  using namespace matmul_int4_detail;
  if (m <= 0 || n <= 0 || k <= 0 || k % 2) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= 16)
    return int8_decode::matmul<PackedInt4Rows>(x, w_packed, x_scale, w_scale, out, m, n, k, 0,
                                               s);
  const auto wp = static_cast<const int8_t*>(w_packed);
  const int vec = (reinterpret_cast<uintptr_t>(w_packed) % 16 == 0) && (n % 16 == 0);
  return int8_tile::launch_scaled_gemm<64, 64>(x, StagePackedInt4<64>{wp, n, k / 2, vec},
                                               x_scale, w_scale, out, m, n, k, 0, s);
}
