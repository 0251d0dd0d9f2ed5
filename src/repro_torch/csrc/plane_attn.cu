// plane_decode_attention: fused GQA decode attention read directly on the
// int4 bit-plane KV cache.
//
// Replaces: repro/kernels/plane_attn.py:_plane_attn_kernel
// (plane_decode_attention, :114).  For each row r = (batch b, kv head h):
//   1. integer scores s[g, l] = Σ_jk s_jk·2^(j+k)·Σ_w popcount(q[g,j,w] & k[l,k,w]),
//      exact and identical to the reference's plane-interleaved contraction;
//   2. score = s · q_scale[g] · k_scale[l] · sm_scale + bias[g, l];
//   3. softmax over L in float32;
//   4. out[g, f] = Σ_l (p[g, l] · v_scale[l]) · v_int4[l, f], the plane values
//      (1, 2, 4, -8) applied to the raw V bits — V is never dequantized to a
//      value matrix in device memory.
//
// q [R, G, 4, Fw] words, q_scale [R, G] and out [R, G, Fw·32] are contiguous.
// K and V planes are read in the cache's stored layout [B, L, H, 4, Fw]
// (scales [B, L, H]) and the bias [B, H, G, L] through the strides the
// wrapper passes, so neither the cache nor the expanded (stride-0) bias is
// copied per step.
//
// Bound on the card: device-memory bytes of the K and V planes and scales,
// R·L·(2·4·Fw·4 + 8) B per layer, plus the bias.  Design (flash-decoding):
// L is split over a thread-block cluster of up to 8 blocks per row, ~64
// slots each, so the grid holds 8 blocks per row (256 at R = 32).  A block
// stages its slots' K and V plane words (64 contiguous bytes per slot at
// Fw = 4, by 16-byte loads) and scales in shared memory, scores one
// (slot, query) per thread, takes its chunk's max and sum (one warp per
// query), and accumulates av one feature per thread over its slots with the
// V words from shared memory — each word leaves device memory once.  The
// splits' (max, sum, out) are combined in rank order through distributed
// shared memory with the online-softmax rescale: one launch, deterministic.
// The bias is finite (-1e30, never -inf): a row with every slot masked gets
// the reference's uniform weights, and a split whose slots are all masked in
// a live row is rescaled by exp(-1e30 - max) = 0 exactly.
//
// G, the query rows of a (batch, kv head) row, is S · (n_heads / n_kv_heads)
// under chunked prefill: up to max_len · 2 on qwen3-1.7b.  The query rows
// are tiled over the grid's third axis, at most kGroupTile a block (fewer
// where the tile would not fit in shared memory), so shared memory stays
// bounded by the tile and not by G.  Each tile re-stages its split's K/V
// words (from L2 after the first tile) and runs the same per-query
// arithmetic: a (row, query)'s result does not depend on the tiling.  The
// decode shape (G = 2) is one tile of two rows.

#include <algorithm>
#include <cfloat>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;       // portable cluster size
constexpr int kSlotsPerSplit = 64;  // target slots per block
constexpr int kGroup = 4;           // queries accumulated per pass over the slots
constexpr int kGroupTile = 16;      // query rows a block takes (grid z tiles G)
constexpr size_t kMaxSmem = 227 * 1024;

struct Layout {  // offsets into dynamic shared memory, in 4-byte words
  int k, v, q, ks, vs, p, o, m, sum, total;
};

__host__ __device__ inline Layout layout(int chunk, int groups, int fw) {
  const int pw = 4 * fw;  // plane words per slot: a multiple of 4 (16 bytes)
  Layout s;
  s.k = 0;
  s.v = s.k + chunk * pw;
  s.q = s.v + chunk * pw;
  s.ks = s.q + groups * pw;
  s.vs = s.ks + chunk;
  s.p = s.vs + chunk;
  s.o = s.p + groups * chunk;
  s.m = s.o + groups * fw * 32;
  s.sum = s.m + groups;
  s.total = s.sum + groups;
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
plane_attn_kernel(const uint32_t* __restrict__ q, const float* __restrict__ q_scale,
                  const uint32_t* __restrict__ kp, const float* __restrict__ k_scale,
                  const uint32_t* __restrict__ vp, const float* __restrict__ v_scale,
                  const float* __restrict__ bias, float* __restrict__ out, int heads,
                  int total_groups, int tile, int slots, int fw, int chunk, long long p_b,
                  long long p_l, long long p_h, long long s_b, long long s_l, long long s_h,
                  long long b_b, long long b_h, long long b_g, long long b_l,
                  float sm_scale, int is_signed, int vec) {
  extern __shared__ float4 smem4[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem4);
  float* flts = reinterpret_cast<float*>(smem4);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x, split = blockIdx.y;
  const int b = r / heads, h = r % heads;
  const int l0 = split * chunk;
  const int n = max(0, min(chunk, slots - l0));  // slots of this block
  const int g0 = blockIdx.z * tile;  // this block's query rows: g0 .. g0 + groups
  const int groups = min(tile, total_groups - g0);
  const int pw = 4 * fw, feat = fw * 32;
  const Layout lay = layout(chunk, tile, fw);
  uint32_t* k_s = words + lay.k;  // [chunk][4][Fw]
  uint32_t* v_s = words + lay.v;
  uint32_t* q_s = words + lay.q;  // [G][4][Fw]
  float* ks_s = flts + lay.ks;    // [chunk]
  float* vs_s = flts + lay.vs;
  float* p_s = flts + lay.p;      // [G][chunk] scores, then p · v_scale
  float* o_s = flts + lay.o;      // [G][feat] this split's unnormalised av
  float* m_s = flts + lay.m;      // [G] this split's max
  float* sum_s = flts + lay.sum;  // [G] this split's Σ p

  // 1. stage this block's K/V plane words, scales and queries
  const long long row_off = b * p_b + h * p_h + l0 * p_l;
  if (vec) {
    const int per = pw / 4;  // 16-byte loads per slot
    for (int i = tid; i < n * per; i += kThreads) {
      const int l = i / per, c = i % per;
      const long long off = row_off + l * p_l;
      reinterpret_cast<uint4*>(k_s)[i] = __ldg(reinterpret_cast<const uint4*>(kp + off) + c);
      reinterpret_cast<uint4*>(v_s)[i] = __ldg(reinterpret_cast<const uint4*>(vp + off) + c);
    }
  } else {
    for (int i = tid; i < n * pw; i += kThreads) {
      const long long off = row_off + (i / pw) * p_l + i % pw;
      k_s[i] = kp[off];
      v_s[i] = vp[off];
    }
  }
  for (int l = tid; l < n; l += kThreads) {
    const long long off = b * s_b + h * s_h + (l0 + l) * s_l;
    ks_s[l] = k_scale[off];
    vs_s[l] = v_scale[off];
  }
  const uint32_t* q_r = q + (static_cast<size_t>(r) * total_groups + g0) * pw;
  for (int i = tid; i < groups * pw; i += kThreads) q_s[i] = q_r[i];
  __syncthreads();

  // 2. integer plane scores, one thread per (query, slot); scales and bias after
  const float* qsc_r = q_scale + static_cast<size_t>(r) * total_groups + g0;
  const float* bias_r = bias + b * b_b + h * b_h + g0 * b_g + l0 * b_l;
  for (int i = tid; i < groups * n; i += kThreads) {
    const int g = i / n, l = i % n;
    const uint32_t* kl = k_s + l * pw;
    const uint32_t* qg = q_s + g * pw;
    int acc = 0;
    for (int wi = 0; wi < fw; ++wi) {
      const uint32_t kw[4] = {kl[wi], kl[fw + wi], kl[2 * fw + wi], kl[3 * fw + wi]};
      const uint32_t qw[4] = {qg[wi], qg[fw + wi], qg[2 * fw + wi], qg[3 * fw + wi]};
      acc += bsdp_word(qw, kw, is_signed);
    }
    p_s[g * chunk + l] = static_cast<float>(acc) * qsc_r[g] * ks_s[l] * sm_scale +
                         bias_r[g * b_g + l * b_l];
  }
  __syncthreads();

  // 3. this split's max and Σ exp, one warp per query; fold v_scale in
  for (int g = warp; g < groups; g += kWarps) {
    float* row = p_s + g * chunk;
    float mx = -FLT_MAX;
    for (int l = lane; l < n; l += 32) mx = fmaxf(mx, row[l]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int l = lane; l < n; l += 32) {
      const float p = expf(row[l] - mx);
      row[l] = p * vs_s[l];
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      sum_s[g] = sum;
    }
  }
  __syncthreads();

  // 4. av against the raw V bits, one thread per feature, plane values (1, 2, 4, ±8)
  const int top = is_signed ? -8 : 8;
  for (int f = tid; f < feat; f += kThreads) {
    const int wi = f >> 5, bit = f & 31;
    for (int gq = 0; gq < groups; gq += kGroup) {
      float acc[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
      for (int l = 0; l < n; ++l) {
        const uint32_t* vl = v_s + l * pw;
        const int val = static_cast<int>((vl[wi] >> bit) & 1u) +
                        2 * static_cast<int>((vl[fw + wi] >> bit) & 1u) +
                        4 * static_cast<int>((vl[2 * fw + wi] >> bit) & 1u) +
                        top * static_cast<int>((vl[3 * fw + wi] >> bit) & 1u);
        const float fv = static_cast<float>(val);
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          if (gq + i < groups) acc[i] = fmaf(p_s[(gq + i) * chunk + l], fv, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (gq + i < groups) o_s[(gq + i) * feat + f] = acc[i];
    }
  }
  cluster.sync();  // every split's (max, sum, out) is written

  // 5. combine the splits in rank order: out = Σ_q e^(m_q - M)·o_q / Σ_q e^(m_q - M)·sum_q
  const int splits = static_cast<int>(cluster.num_blocks());
  const int total = groups * feat;
  const int per = (total + splits - 1) / splits;
  for (int i = tid; i < per; i += kThreads) {
    const int idx = static_cast<int>(cluster.block_rank()) * per + i;
    if (idx >= total) break;
    const int g = idx / feat;
    float mq[kMaxSplits];
    float mx = -FLT_MAX;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        mq[s] = cluster.map_shared_rank(m_s, s)[g];
        mx = fmaxf(mx, mq[s]);
      }
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits) {
        const float e = expf(mq[s] - mx);
        den += e * cluster.map_shared_rank(sum_s, s)[g];
        num += e * cluster.map_shared_rank(o_s, s)[idx];
      }
    }
    out[(static_cast<size_t>(r) * total_groups + g0) * feat + idx] = num / den;
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

}  // namespace

extern "C" int plane_decode_attention(const void* q, const void* q_scale, const void* kp,
                                      const void* k_scale, const void* vp,
                                      const void* v_scale, const void* bias, void* out,
                                      int batch, int heads, int groups, int slots, int fw,
                                      long long p_b, long long p_l, long long p_h,
                                      long long s_b, long long s_l, long long s_h,
                                      long long b_b, long long b_h, long long b_g,
                                      long long b_l, float sm_scale, int is_signed,
                                      void* stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || slots <= 0 || fw <= 0)
    return cudaErrorInvalidValue;
  const int splits = std::min(kMaxSplits, (slots + kSlotsPerSplit - 1) / kSlotsPerSplit);
  const int chunk = (slots + splits - 1) / splits;
  int tile = std::min(groups, kGroupTile);
  while (tile > 1 && sizeof(float) * layout(chunk, tile, fw).total > kMaxSmem) tile /= 2;
  const size_t smem = sizeof(float) * layout(chunk, tile, fw).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // one split's K/V alone does not fit
  cudaError_t err = allow_smem(plane_attn_kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = (reinterpret_cast<uintptr_t>(kp) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(vp) % 16 == 0) && p_b % 4 == 0 &&
                  p_l % 4 == 0 && p_h % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * heads, splits, (groups + tile - 1) / tile);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, plane_attn_kernel, static_cast<const uint32_t*>(q),
      static_cast<const float*>(q_scale), static_cast<const uint32_t*>(kp),
      static_cast<const float*>(k_scale), static_cast<const uint32_t*>(vp),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias),
      static_cast<float*>(out), heads, groups, tile, slots, fw, chunk, p_b, p_l, p_h, s_b, s_l,
      s_h, b_b, b_h, b_g, b_l, sm_scale, is_signed, vec);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
