// The bit-plane GEMM on the binary tensor-core instruction, shared by
// bsdp_gemm (the unrolled form) and bsdp_gemm_fused (the plane-interleaved
// contraction):
//
//   out[m, n] = sum_{j,k} s_jk · 2^(j+k) · popcount(x_j[m] AND w_k[n])
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
// Every sum is an exact integer sum, so both forms are bit-identical to each
// other and to the plain versions, in any order of summation.
//
// At decode (M = slots) the contraction is bound by the weight planes'
// bytes, N·4·Kw·4 (12.6 MB at w_in, 6.3 MB at w_out: 0.0038 / 0.0019 ms at
// 3.35 TB/s), so the plane words go from a 16-byte load straight into the
// instruction (no 0/1 bytes, no shared memory but for the K splits).  The
// binary mma.sync m16n8k256 .b1 .and.popc is one AND-popcount contraction
// of 256 K elements.  Its 16 A rows are 4 tokens × 4 activation planes (row
// j·4 + token), so at M = 4 no row is padding.  Its 8 B columns are where
// the two forms differ (FUSED):
//   unrolled — 8 weight columns of one weight plane k; a warp runs one chain
//     per plane (4 fragments), and D element (row, col) is the (j, k) pair
//     sum of one token and one column;
//   fused — 2 weight columns × 4 weight planes, B column c·4 + k: rows
//     n·4 + k of wt viewed as [N·4, Kw], the plane-interleaved operand as it
//     lies in memory; one instruction gives the whole pair table of 4 tokens
//     × 2 columns, and a warp's 8 columns take 4 fragments.
// Both take the same bytes and the same count of instructions per output.
// s_jk·2^(j+k) is applied once in the epilogue (int32); shuffles add the
// pairs held by other lanes (planes j and j + 2 are 16 lanes apart; in the
// fused form weight planes 0, 1 and 2, 3 are neighbouring lanes).  The sum
// over K does not depend on which K element a bit stands for, as long as x
// and w agree, so lane t of a warp loads words 4t..4t+3 of each 16-word
// unit (two instructions: words 4t, 4t+1 and 4t+2, 4t+3).
//
// A warp owns 8 columns; it issues all the weight loads of its K range (up
// to UMAX units × 4 fragments × 16 bytes a lane) before the first
// instruction, and reads its activation words through the L1 (every warp of
// a block reads the same ones).  K is split over the 8 warps of a block when
// a warp's range would not fit its registers or the grid would not fill one
// wave of the card (the SM count is read at run time): at w_in M = 4, 192
// blocks of 8 column groups, each warp 4 units (256 bytes a lane in
// flight); at w_out, 256 blocks of 8 K splits, each warp up to 2 units.  The
// splits meet in shared memory in split order.  One launch, no atomics.
//
// Above M = 4 a block holds 16 tokens (4 row tiles, each reusing the
// weight fragments, 1 unit of weight loads in flight so that nothing
// spills under the 2-blocks-per-SM register cap), and the grid's second
// axis walks the tokens 16 at a time: prefill (M = a prompt's length) is
// the same contraction, its weight words re-read from the L2 by each
// 16-token block.  Row tiles past M are skipped (block-uniform).
//
// Grouped launch (the experts of a MoE layer): the grid's third axis walks
// `groups` independent contractions of the same shape, stacked in memory —
// x [G, M, 4, Kw], wt [G, N, 4, Kw], out [G, M, N] — so a layer's 64 expert
// projections are one launch.  The K split counts the whole grid when it
// asks whether one wave of the card is filled.
#pragma once

#include "common.cuh"
#include "split_k.cuh"

namespace bsdp_mma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnitWords = 16;  // plane words per unit: 512 K elements, two mma steps
constexpr int kMaxSplits = kWarps;

// d += popcount-and contraction of A (16 x 256 bits) with B (256 x 8 bits).
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Words row[w .. w+3], zero past kw.  VEC: the row is 16-byte aligned and kw
// a multiple of 4, so one load covers them.
template <bool VEC>
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ row, int w, int kw) {
  if (VEC)
    return w < kw ? __ldg(reinterpret_cast<const uint4*>(row + w)) : make_uint4(0u, 0u, 0u, 0u);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = w + e < kw ? __ldg(row + w + e) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The body of both kernels.  RT row tiles of 4 tokens per block, blockIdx.y
// the block's RT·4 tokens; UMAX units of weight loads in flight per lane.
// Warp w owns column group w % col_groups and K split w / col_groups, whose
// units are [split · units_per_warp, +units_per_warp).
template <bool FUSED, int RT, int UMAX, bool VEC>
__device__ __forceinline__ void contract(const uint32_t* __restrict__ x,
                                         const uint32_t* __restrict__ wt,
                                         int32_t* __restrict__ out, int m_rows, int n_cols,
                                         int kw, int is_signed, int col_groups,
                                         int units_per_warp) {
  __shared__ int part[kWarps][RT * 4][8];  // each warp's sums: token x column
  // this block's group (expert) of a grouped launch, then its tokens
  x += static_cast<size_t>(blockIdx.z) * m_rows * 4 * kw;
  wt += static_cast<size_t>(blockIdx.z) * n_cols * 4 * kw;
  out += static_cast<size_t>(blockIdx.z) * m_rows * n_cols;
  const int m0 = blockIdx.y * RT * 4;
  x += static_cast<size_t>(m0) * 4 * kw;
  out += static_cast<size_t>(m0) * n_cols;
  m_rows = min(m_rows - m0, RT * 4);  // this block's tokens
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column group, thread in group
  const int cgrp = warp % col_groups, split = warp / col_groups;
  const int n_base = (blockIdx.x * col_groups + cgrp) * 8;
  const int units = (kw + kUnitWords - 1) / kUnitWords;
  const int u_begin = split * units_per_warp;
  const int u_end = min(units, u_begin + units_per_warp);
  // B column g of fragment f is weight column b_col(f), row r0 + f·kStep of wt
  // viewed as [N·4, Kw] (unrolled: plane f; fused: plane g % 4)
  auto b_col = [&](int f) { return FUSED ? n_base + 2 * f + (g >> 2) : n_base + g; };
  constexpr int kStep = FUSED ? 8 : 1;
  const int r0 = FUSED ? b_col(0) * 4 + (g & 3) : b_col(0) * 4;
  const uint32_t* wrow = wt + static_cast<size_t>(min(r0, n_cols * 4 - 1)) * kw;

  int acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][f][e] = 0;

  for (int u0 = u_begin; u0 < u_end; u0 += UMAX) {
    // every weight load of this pass in flight before any is used
    uint4 wr[UMAX][4];
#pragma unroll
    for (int u = 0; u < UMAX; ++u)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        wr[u][f] = (b_col(f) < n_cols && u0 + u < u_end)
                       ? load_words<VEC>(wrow + f * kStep * kw, (u0 + u) * kUnitWords + 4 * t, kw)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < UMAX; ++u) {
      if (u0 + u < u_end) {
        const int w = (u0 + u) * kUnitWords + 4 * t;
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          if (rt * 4 >= m_rows) break;  // block-uniform: no token in this tile
          // A rows g (plane g >> 2) and g + 8 (plane (g >> 2) + 2), token rt·4 + (g & 3)
          const int tok = rt * 4 + (g & 3);
          uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
          if (tok < m_rows) {
            const uint32_t* xrow = x + (static_cast<size_t>(tok) * 4 + (g >> 2)) * kw;
            xa = load_words<VEC>(xrow, w, kw);
            xb = load_words<VEC>(xrow + 2 * kw, w, kw);
          }
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            mma_and_popc(acc[rt][f], xa.x, xb.x, xa.y, xb.y, wr[u][f].x, wr[u][f].y);
            mma_and_popc(acc[rt][f], xa.z, xb.z, xa.w, xb.w, wr[u][f].z, wr[u][f].w);
          }
        }
      }
    }
  }

  // D elements 0, 1: row g, B columns 2t, 2t+1; elements 2, 3: row g + 8.
  const int j = g >> 2;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    if (FUSED) {
      // B columns 2t, 2t+1 are weight column 2f + (t >> 1), planes k and k + 1
      const int k = 2 * (t & 1);
      const int w00 = plane_pair_weight(j, k, is_signed);
      const int w01 = plane_pair_weight(j, k + 1, is_signed);
      const int w20 = plane_pair_weight(j + 2, k, is_signed);
      const int w21 = plane_pair_weight(j + 2, k + 1, is_signed);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        int s = w00 * acc[rt][f][0] + w01 * acc[rt][f][1] + w20 * acc[rt][f][2] +
                w21 * acc[rt][f][3];
        s += __shfl_xor_sync(0xffffffffu, s, 1);   // weight planes 0, 1 + 2, 3
        s += __shfl_xor_sync(0xffffffffu, s, 16);  // activation planes 0, 2 + 1, 3
        if (lane < 16 && (t & 1) == 0) part[warp][rt * 4 + g][2 * f + (t >> 1)] = s;
      }
    } else {
      // B columns 2t, 2t+1 are weight columns 2t, 2t+1 of plane f
      int s0 = 0, s1 = 0;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int lo = plane_pair_weight(j, f, is_signed);
        const int hi = plane_pair_weight(j + 2, f, is_signed);
        s0 += lo * acc[rt][f][0] + hi * acc[rt][f][2];
        s1 += lo * acc[rt][f][1] + hi * acc[rt][f][3];
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 16);  // planes 0, 2 + planes 1, 3
      s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
      if (lane < 16) {  // g = token within the tile
        part[warp][rt * 4 + g][2 * t] = s0;
        part[warp][rt * 4 + g][2 * t + 1] = s1;
      }
    }
  }
  __syncthreads();
  const int splits = kWarps / col_groups;
  for (int o = threadIdx.x; o < col_groups * RT * 4 * 8; o += kThreads) {
    const int c = o % 8, tok = (o / 8) % (RT * 4), cg = o / (8 * RT * 4);
    const int gn = (blockIdx.x * col_groups + cg) * 8 + c;
    if (tok >= m_rows || gn >= n_cols) continue;
    int s = 0;
    for (int q = 0; q < splits; ++q) s += part[q * col_groups + cg][tok][c];
    out[static_cast<size_t>(tok) * n_cols + gn] = s;
  }
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, int32_t*, int, int, int, int, int, int);

// Launch one kernel instance over `groups` stacked contractions: `aligned`
// when x and wt are 16-byte aligned and kw a multiple of 4 (then every
// group's operands are too), else `unaligned`.  K splits: the fewest (a
// power of 2, at most one per warp and one per unit) for which a warp's
// units fit UMAX and the grid fills one wave of the card.
template <int RT, int UMAX>
int launch(Kernel aligned, Kernel unaligned, const void* x, const void* wt, void* out,
           int groups, int m, int n, int kw, int is_signed, void* stream) {
  if (groups <= 0 || groups > 65535) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = split_k::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int row_blocks = (m + 4 * RT - 1) / (4 * RT);
  if (row_blocks > 65535) return cudaErrorInvalidValue;
  const int units = (kw + kUnitWords - 1) / kUnitWords;
  auto blocks = [n](int splits) {
    const int cols = 8 * (kWarps / splits);
    return (n + cols - 1) / cols;
  };
  int splits = 1;
  while (splits < kMaxSplits && splits < units &&
         ((units + splits - 1) / splits > UMAX ||
          static_cast<long long>(blocks(splits)) * row_blocks * groups < sms))
    splits *= 2;
  const int per_warp = (units + splits - 1) / splits;
  const bool vec = kw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  const Kernel kernel = vec ? aligned : unaligned;
  const dim3 grid(blocks(splits), row_blocks, groups);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(wt),
      static_cast<int32_t*>(out), m, n, kw, is_signed, kWarps / splits, per_warp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsdp_mma
