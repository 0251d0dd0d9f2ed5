// The decode route (M <= 16) shared by matmul_int8 (W8A8),
// matmul_int4_packed (W4A8) and matmul_w16a8 (DIM): int8 activations
// against a weight held as it lies in device memory — int8 [K, N], int4
// packed two per byte [K/2, N], or int16 [K, N] read as its bytes — into
// exact integer sums, with the scale epilogue
//
//   out[m, n] = (float(acc[m, n]) * x_scale[m]) * w_scale[n]    (out_int32 = 0)
//   out[m, n] = acc[m, n]                                       (out_int32 = 1)
//
// in the reference's order, in float32 with round-to-nearest, once on the
// whole integer sum, or for DIM the int32 output 256·(x·hi) + x·lo.  The
// kernels differ only in the weight loader (a policy: Int8Rows and
// Int16Bytes here, PackedInt4Rows in matmul_int4_packed.cu).  Partial sums
// are uint32_t, so every add is defined modulo 2^32: the int8 and int4 sums
// never leave int32, and DIM's result is defined modulo 2^32 (the
// reference's int32 wrap), which sums in any order reach exactly.
//
// Bound by the weight's bytes (4.2 MB int8 / 2.1 MB int4 at wq: 0.0013 /
// 0.0006 ms at 3.35 TB/s).  The weight has to be requested almost all at
// once, so K is split over a thread-block cluster of up to 8 blocks, until
// the grid holds about two blocks per SM (the SM count is read at run time;
// the split counts chunks of loads, so it counts bytes, not K rows).  Up to
// M = 4 a block owns 128 columns (8 threads across, 16 columns each): grid
// 16 × 8 at K = N = 2048, 96 × 2 at w_in, 16 × 8 at w_out; M <= 16 takes 64
// columns.  A thread's unit is 4 16-byte weight loads, 16 columns each: 4 K
// rows of int8, or 4 packed rows = 8 K rows of int4.  Each thread issues all
// of its loads of a chunk (Q units) before it uses any, and the next
// chunk's while it contracts this one; at M = 1, whose blocks do few
// products, a thread loads 2 units a chunk when 1 would not fit the grid in
// one wave of a block per SM.  The loader turns a unit into quads of 4 K
// rows × 16 columns of int8 in registers (int4: the nibbles sign-extended
// per byte), a quad is transposed by 8 __byte_perm per 4 columns into one
// word per column (its 4 rows) and contracted with the activation's word of
// the same 4 rows by __dp4a: 1.5 instructions a weight byte at M = 4 for
// int8.  The activation slice is staged in shared memory as 4-row words (by
// 4-byte loads, or byte by byte when x is unaligned or K is not a multiple
// of 4).  Up to M = 4 a thread's 16 column partials per row of x stay in
// registers over its whole K range; then a butterfly of shuffles sums them
// over the warp's units, the 8 warps' partials are summed in a fixed order
// in shared memory, and the cluster's K splits in rank order through
// distributed shared memory (at M <= 16 the butterfly runs per chunk, 4 rows
// of x at a time, into shared memory).  The weight is never staged in
// shared memory.  One launch, no workspace in device memory, no atomics:
// deterministic.
//
// Grouped launch (the experts of a MoE layer, matmul_int8): the grid's
// third axis walks `groups` independent products of the same shape,
// stacked in memory — x [G, M, K], the weight [G, rows, N], x_scale [G, M],
// w_scale [G, N], out [G, M, N] — one launch for a layer's 64 expert
// projections; the K split counts the whole grid.  The cluster stays along
// the grid's second axis.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"
#include "split_k.cuh"

namespace int8_decode {

namespace cgr = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;    // portable cluster size
constexpr int kRowGroup = 4;     // rows of x accumulated per pass
constexpr int kBlocksPerSM = 2;  // resident blocks per SM (__launch_bounds__)

// A block's column tile: TPR threads across it, 16 columns each (one 16-byte
// load a row), and 256 / TPR units down it per load round.
template <int TPR>
struct Tile {
  static_assert(TPR == 4 || TPR == 8, "a warp holds 4 or 8 units");
  static constexpr int kBN = 16 * TPR;          // columns per block
  static constexpr int kUnits = kThreads / TPR;  // units per load round
  static constexpr int kKeep = TPR / 2;          // columns a lane keeps after the butterfly
};

// 16 bytes of row `row` of a [rows, n_cols] int8 matrix, columns n .. n+15
// (zeros outside the matrix or when !ok).
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w, int row, bool ok, int n,
                                          int n_cols) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || n >= n_cols) return r;
  const int8_t* p = w + static_cast<size_t>(row) * n_cols + n;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (n + c < n_cols)
      b[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * (c & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// 4 rows × 4 columns of int8 (one word a row) → 4 words, word c holding
// column c's 4 rows (row r in byte r), the operand layout of __dp4a.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* col) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  col[0] = __byte_perm(ab_lo, cd_lo, 0x5410);  // a0 b0 c0 d0
  col[1] = __byte_perm(ab_lo, cd_lo, 0x7632);  // a1 b1 c1 d1
  col[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  col[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// The int8 weight [K, N]: a unit is one quad, K rows k .. k+3.
struct Int8Rows {
  static constexpr int kQuads = 1;  // quads of 4 K rows per unit
  static constexpr bool kDim = false;

  template <bool VEC>
  static __device__ __forceinline__ void load(uint4 (&raw)[4], const int8_t* __restrict__ w,
                                              int k, int k_end, int n, int n_cols) {
#pragma unroll
    for (int r = 0; r < 4; ++r) raw[r] = load_w16<VEC>(w, k + r, k + r < k_end, n, n_cols);
  }

  static __device__ __forceinline__ void quad(const uint4 (&raw)[4], int, uint32_t (&col)[16]) {
    const uint32_t a[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
    const uint32_t b[4] = {raw[1].x, raw[1].y, raw[1].z, raw[1].w};
    const uint32_t c[4] = {raw[2].x, raw[2].y, raw[2].z, raw[2].w};
    const uint32_t d[4] = {raw[3].x, raw[3].y, raw[3].z, raw[3].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) transpose4(a[q], b[q], c[q], d[q], col + 4 * q);
  }
};

// DIM's int16 weight [K, N] read as its bytes, an int8 [K, 2N] matrix
// (little-endian): byte column 2n is w[:, n]'s low byte, taken unsigned,
// and 2n + 1 its high byte, taken signed (w >> 8, arithmetic), so that
// x·w = 256·(x·hi) + x·lo with no row-sum correction.  The loads, the
// transpose and the K split are the int8 weight's; the contraction uses the
// mixed-sign dp4a.u32.s32 on the low bytes, and the epilogue combines each
// column's two sums.
struct Int16Bytes : Int8Rows {
  static constexpr bool kDim = true;
};

// acc + Σ_i w_i·x_i over the 4 byte lanes, modulo 2^32, x's bytes signed and
// w's signed, or unsigned when `w_unsigned` (DIM's low bytes).
__device__ __forceinline__ uint32_t dot4(uint32_t w, uint32_t x, uint32_t acc,
                                         bool w_unsigned) {
  if (w_unsigned) {
    uint32_t d;
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(w), "r"(x), "r"(acc));
    return d;
  }
  return static_cast<uint32_t>(
      __dp4a(static_cast<int>(w), static_cast<int>(x), static_cast<int>(acc)));
}

// Keep half of `v` (the half picked by `upper`), adding the partner lane's
// copy of it: a reduce-scatter step over lanes `mask` apart.
template <int HALF>
__device__ __forceinline__ void butterfly_step(uint32_t* v, int mask, bool upper) {
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const uint32_t send = upper ? v[c] : v[c + HALF];
    const uint32_t keep = upper ? v[c + HALF] : v[c];
    v[c] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// L: the weight loader; MT: rows of x the shared buffers hold (1, 4 or 16);
// Q: units of weight loads a thread issues per chunk; VEC: w 16-byte aligned
// and N % 16 == 0; XVEC: x 4-byte aligned and K % 4 == 0.
template <typename L, int MT, int Q, int TPR, bool VEC, bool XVEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ x_scale, const float* __restrict__ w_scale,
              void* __restrict__ out, int m_rows, int n_cols, int k_dim, int k_per_split,
              int out_int32) {
  using T = Tile<TPR>;
  constexpr int kBN = T::kBN, kUnits = T::kUnits;
  constexpr int kUnitK = 4 * L::kQuads;  // K rows per unit
  constexpr int kKC = kUnits * kUnitK * Q;  // K rows per chunk
  constexpr int kXW = kKC / 4;              // words of one row of x per chunk
  constexpr int kMG = MT < kRowGroup ? MT : kRowGroup;
  extern __shared__ int4 smem4[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem4);  // [MT][kXW] x slice
  uint32_t* red = xs + MT * kXW;              // [kWarps][MT][kBN]
  uint32_t* part = red + kWarps * MT * kBN;  // [MT][kBN] this split

  cgr::cluster_group cluster = cgr::this_cluster();
  {  // this block's group of a grouped launch (the weight: k_dim / kQuads rows)
    constexpr int kPair = L::kDim ? 2 : 1;
    const size_t z = blockIdx.z;
    x += z * m_rows * k_dim;
    w += z * (k_dim / L::kQuads) * n_cols;
    if (!L::kDim) {
      x_scale += z * m_rows;
      w_scale += z * n_cols;
    }
    out = static_cast<char*>(out) + z * m_rows * (n_cols / kPair) * sizeof(int32_t);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = tid / TPR;              // unit within a load round
  const int n0 = blockIdx.x * kBN;
  const int ncol = n0 + (tid % TPR) * 16;  // this thread's 16 weight columns
  const int k_begin = blockIdx.y * k_per_split;  // a multiple of kUnitK (so of 4)
  const int k_end = min(k_dim, k_begin + k_per_split);
  // the T::kKeep columns this lane holds after the butterfly over its unit bits
  const int ocol = (tid % TPR) * 16 + ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                   (TPR == 4 ? ((lane >> 2) & 1) * 2 : 0);
  uint32_t* my_red = red + warp * MT * kBN + ocol;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < T::kKeep; ++c) my_red[m * kBN + c] = 0;

  // every weight load of a chunk in flight before any is used, and the next
  // chunk's in flight while this one is contracted
  uint4 raw[Q][4], next[Q][4];
  // a thread's Q units of the chunk at k0: K rows k0 + (unit + q·kUnits)·kUnitK + ..
  auto load_chunk = [&](uint4 (&dst)[Q][4], int k0) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
      L::template load<VEC>(dst[q], w, k0 + (unit + q * kUnits) * kUnitK, k_end, ncol, n_cols);
  };
  // x[:, k0 .. k0 + kKC) as 4-row words into xs, zero past k_end
  auto stage_x = [&](int k0) {
    for (int idx = tid; idx < m_rows * kXW; idx += kThreads) {
      const int m = idx / kXW, k = k0 + 4 * (idx % kXW);
      const int8_t* px = x + static_cast<size_t>(m) * k_dim + k;
      uint32_t v = 0u;
      if (XVEC && k + 4 <= k_end) {
        v = *reinterpret_cast<const uint32_t*>(px);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < k_end) v |= static_cast<uint32_t>(static_cast<uint8_t>(px[e])) << (8 * e);
      }
      xs[idx] = v;
    }
  };
  // p[mm][c] += the chunk's products of row mg + mm of x with column c
  auto contract = [&](uint32_t (&p)[kMG][16], int mg) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int qq = 0; qq < L::kQuads; ++qq) {
        uint32_t col[16];
        L::quad(raw[q], qq, col);
        const int xw = (unit + q * kUnits) * L::kQuads + qq;  // its 4 rows' word of x
#pragma unroll
        for (int mm = 0; mm < kMG; ++mm) {
          if (mg + mm < m_rows) {
            const uint32_t xv = xs[(mg + mm) * kXW + xw];
#pragma unroll
            for (int c = 0; c < 16; ++c)
              p[mm][c] = dot4(col[c], xv, p[mm][c], L::kDim && c % 2 == 0);
          }
        }
      }
  };
  // the warp's units summed by the butterfly, into this warp's partials
  auto reduce = [&](uint32_t (&p)[kMG][16], int mg) {
#pragma unroll
    for (int mm = 0; mm < kMG; ++mm) {
      if (mg + mm < m_rows) {
        butterfly_step<8>(p[mm], 16, lane & 16);
        butterfly_step<4>(p[mm], 8, lane & 8);
        if (TPR == 4) butterfly_step<2>(p[mm], 4, lane & 4);
#pragma unroll
        for (int c = 0; c < T::kKeep; ++c) my_red[(mg + mm) * kBN + c] += p[mm][c];
      }
    }
  };
  auto clear = [](uint32_t (&p)[kMG][16]) {
#pragma unroll
    for (int mm = 0; mm < kMG; ++mm)
#pragma unroll
      for (int c = 0; c < 16; ++c) p[mm][c] = 0;
  };

  // At MT <= 4 the partials stay in registers over the whole K range and the
  // butterfly runs once; at MT = 16 it runs per chunk, 4 rows of x at a time.
  uint32_t acc[kMG][16];
  clear(acc);
  load_chunk(raw, k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kKC) {
    if (k0 + kKC < k_end) load_chunk(next, k0 + kKC);
    __syncthreads();  // the previous chunk's reads of xs are done
    stage_x(k0);
    __syncthreads();
    if (MT <= kRowGroup) {
      contract(acc, 0);
    } else {
      for (int mg = 0; mg < m_rows; mg += kMG) {  // uniform across the block
        uint32_t p[kMG][16];
        clear(p);
        contract(p, mg);
        reduce(p, mg);
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) raw[q][r] = next[q][r];
  }
  if (MT <= kRowGroup) reduce(acc, 0);
  __syncthreads();
  for (int idx = tid; idx < m_rows * kBN; idx += kThreads) {
    uint32_t s = 0;
    for (int wv = 0; wv < kWarps; ++wv) s += red[wv * MT * kBN + idx];
    part[idx] = s;
  }
  cluster.sync();  // every split's part is written
  // this block's share of the tile's outputs, summed over the splits in rank order
  // (DIM: an output is a pair of byte columns, the int16 weight's column)
  constexpr int kPair = L::kDim ? 2 : 1;
  constexpr int kOut = kBN / kPair;  // outputs of a tile row
  const int out_cols = n_cols / kPair;
  const int splits = static_cast<int>(cluster.num_blocks());
  const int total = m_rows * kOut;
  const int per = (total + splits - 1) / splits;
  for (int i = tid; i < per; i += kThreads) {
    const int idx = static_cast<int>(cluster.block_rank()) * per + i;
    if (idx >= total) break;
    const int gm = idx / kOut, gn = n0 / kPair + idx % kOut;
    const int at_part = gm * kBN + (idx % kOut) * kPair;
    uint32_t s = 0, hi = 0;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) {
      if (q < splits) {
        const uint32_t* pq = cluster.map_shared_rank(part, q);
        s += pq[at_part];
        if (L::kDim) hi += pq[at_part + 1];
      }
    }
    if (gn >= out_cols) continue;
    const size_t at = static_cast<size_t>(gm) * out_cols + gn;
    if (L::kDim) {
      static_cast<int32_t*>(out)[at] = static_cast<int32_t>((hi << 8) + s);  // modulo 2^32
    } else if (out_int32) {
      static_cast<int32_t*>(out)[at] = static_cast<int32_t>(s);
    } else {
      static_cast<float*>(out)[at] = __fmul_rn(
          __fmul_rn(__int2float_rn(static_cast<int>(s)), x_scale[gm]), w_scale[gn]);
    }
  }
  cluster.sync();  // no block leaves while another still reads its part
}

template <typename L, int MT, int Q, int TPR, bool VEC, bool XVEC>
cudaError_t launch_tile(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                        void* out, int groups, int m, int n, int k, int out_int32,
                        cudaStream_t stream) {
  constexpr int kBN = Tile<TPR>::kBN;
  constexpr int kUnitK = 4 * L::kQuads;
  constexpr int kKC = Tile<TPR>::kUnits * kUnitK * Q;
  int sms = 0;
  cudaError_t err = split_k::sm_count(&sms);
  if (err != cudaSuccess) return err;
  // K splits until the grid holds about kBlocksPerSM blocks per SM (one wave)
  const int col_blocks = (n + kBN - 1) / kBN;
  int splits = std::max(1, std::min({kMaxSplits, (k + kKC - 1) / kKC,
                                     kBlocksPerSM * sms / (col_blocks * groups)}));
  const int k_per_split = ((k + splits - 1) / splits + kUnitK - 1) / kUnitK * kUnitK;
  splits = (k + k_per_split - 1) / k_per_split;  // no empty split
  auto kernel = decode_kernel<L, MT, Q, TPR, VEC, XVEC>;
  const size_t smem = sizeof(int) * (MT * kKC / 4 + kWarps * MT * kBN + MT * kBN);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_blocks, splits, groups);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;  // the K splits of a column tile
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, xs, ws, out, m, n, k, k_per_split, out_int32);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Tiles by M: 128 columns (8 threads across) up to M = 4, where a lane's
// column partials for every row of x stay in registers over the K range; 64
// columns at M <= 16, whose partials go to shared memory per chunk.  Units
// of weight loads in flight per thread: 1, or at M = 1, where a block's
// products are few, 2 (half the K splits, twice the bytes per block) when
// the 1-unit grid would not fit in one wave of a block per SM.
template <typename L, bool VEC, bool XVEC>
cudaError_t launch_for_m(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                         void* out, int groups, int m, int n, int k, int out_int32,
                         cudaStream_t stream) {
  if (m <= 1) {
    using T = Tile<8>;
    constexpr int kRound = T::kUnits * 4 * L::kQuads;  // K rows of one load round
    int sms = 0;
    const cudaError_t err = split_k::sm_count(&sms);
    if (err != cudaSuccess) return err;
    const long long blocks1 = static_cast<long long>((n + T::kBN - 1) / T::kBN) *
                              std::min(kMaxSplits, (k + kRound - 1) / kRound) * groups;
    if (blocks1 > sms)
      return launch_tile<L, 1, 2, 8, VEC, XVEC>(x, w, xs, ws, out, groups, m, n, k,
                                                out_int32, stream);
    return launch_tile<L, 1, 1, 8, VEC, XVEC>(x, w, xs, ws, out, groups, m, n, k,
                                              out_int32, stream);
  }
  if (m <= 4)
    return launch_tile<L, 4, 1, 8, VEC, XVEC>(x, w, xs, ws, out, groups, m, n, k,
                                              out_int32, stream);
  return launch_tile<L, 16, 1, 4, VEC, XVEC>(x, w, xs, ws, out, groups, m, n, k,
                                             out_int32, stream);
}

// The decode route for 1 <= m <= 16; w is the loader's weight ([K, N] int8
// or [K/2, N] packed int4, N bytes a row), `groups` of them stacked with
// their x, scales and out.  Returns the launch's cudaError_t.
template <typename L>
int matmul(const void* x, const void* w, const void* x_scale, const void* w_scale, void* out,
           int m, int n, int k, int out_int32, cudaStream_t stream, int groups = 1) {
  if (groups <= 0 || groups > 65535) return cudaErrorInvalidValue;
  const auto xp = static_cast<const int8_t*>(x);
  const auto wp = static_cast<const int8_t*>(w);
  const auto xs = static_cast<const float*>(x_scale);
  const auto ws = static_cast<const float*>(w_scale);
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && n % 16 == 0;
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 4 == 0 && k % 4 == 0;
  cudaError_t err;
  if (vec)
    err = xvec ? launch_for_m<L, true, true>(xp, wp, xs, ws, out, groups, m, n, k, out_int32,
                                             stream)
               : launch_for_m<L, true, false>(xp, wp, xs, ws, out, groups, m, n, k, out_int32,
                                              stream);
  else
    err = xvec ? launch_for_m<L, false, true>(xp, wp, xs, ws, out, groups, m, n, k, out_int32,
                                              stream)
               : launch_for_m<L, false, false>(xp, wp, xs, ws, out, groups, m, n, k, out_int32,
                                               stream);
  return static_cast<int>(err);
}

}  // namespace int8_decode
