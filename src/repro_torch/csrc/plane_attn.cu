// plane_decode_attention: fused GQA decode attention read directly on the
// int4 bit-plane KV cache.
//
// Replaces: repro/kernels/plane_attn.py:_plane_attn_kernel
// (plane_decode_attention, :114).  One block per row r = (batch b, kv head h):
//   1. integer scores s[g, l] = Σ_jk s_jk·2^(j+k)·Σ_w popcount(q[g,j,w] & k[l,k,w]),
//      exact and identical to the reference's plane-interleaved contraction;
//   2. score = s · q_scale[g] · k_scale[l] · sm_scale + bias[g, l];
//   3. softmax over L in float32 (two passes over scores kept in shared memory);
//   4. out[g, f] = Σ_l (p[g, l] · v_scale[l]) · v_int4[l, f], the plane values
//      (1, 2, 4, -8) applied to the raw V bits — V is never dequantized to a
//      value matrix in device memory.
//
// q [R, G, 4, Fw] words, q_scale [R, G], bias [R, G, L] and out [R, G, Fw·32]
// are contiguous.  K and V planes are read in the cache's stored layout
// [B, L, H, 4, Fw] (scales [B, L, H]) through the strides the wrapper passes,
// so no transposed copy of the cache is made per step.
//
// Bound on the card: device-memory bytes of the K and V planes and scales,
// R·L·(2·4·Fw·4 + 8) B per layer, plus the bias.  Design: each block streams
// its row's K planes once for the scores (the G queries of a GQA group share
// each loaded K word), keeps the G×L scores in shared memory, and reads the V
// words once per output feature from L1 (lanes of a warp share each word).
// The bias is finite (-1e30, never -inf), so a row with every slot masked
// gets the reference's uniform weights rather than NaN.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // queries scored per pass over a K slot

__device__ float block_reduce(float v, bool is_max, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < kWarps; ++i) r = is_max ? fmaxf(r, scratch[i]) : r + scratch[i];
  return r;
}

__global__ void __launch_bounds__(kThreads)
plane_attn_kernel(const uint32_t* __restrict__ q, const float* __restrict__ q_scale,
                  const uint32_t* __restrict__ kp, const float* __restrict__ k_scale,
                  const uint32_t* __restrict__ vp, const float* __restrict__ v_scale,
                  const float* __restrict__ bias, float* __restrict__ out, int heads,
                  int groups, int slots, int fw, long long p_b, long long p_l,
                  long long p_h, long long s_b, long long s_l, long long s_h,
                  float sm_scale, int is_signed) {
  extern __shared__ unsigned char smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);               // [G][L]
  uint32_t* qs = reinterpret_cast<uint32_t*>(sc + groups * slots);  // [G][4][Fw]
  __shared__ float scratch[kWarps];

  const int r = blockIdx.x;
  const int b = r / heads, h = r % heads;
  const uint32_t* qr = q + static_cast<size_t>(r) * groups * 4 * fw;
  for (int i = threadIdx.x; i < groups * 4 * fw; i += kThreads) qs[i] = qr[i];
  __syncthreads();

  const uint32_t* k_row = kp + b * p_b + h * p_h;
  const uint32_t* v_row = vp + b * p_b + h * p_h;
  const float* ks_row = k_scale + b * s_b + h * s_h;
  const float* vs_row = v_scale + b * s_b + h * s_h;
  const float* bias_r = bias + static_cast<size_t>(r) * groups * slots;
  const float* qsc_r = q_scale + static_cast<size_t>(r) * groups;

  // 1-2. integer plane scores, scales folded after, additive bias
  for (int l = threadIdx.x; l < slots; l += kThreads) {
    const uint32_t* kl = k_row + l * p_l;
    const float kscale = ks_row[l * s_l];
    for (int g0 = 0; g0 < groups; g0 += kGroup) {
      int acc[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0;
      for (int wi = 0; wi < fw; ++wi) {
        const uint32_t kw[4] = {kl[wi], kl[fw + wi], kl[2 * fw + wi], kl[3 * fw + wi]};
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int g = g0 + i;
          if (g < groups) {
            const uint32_t* qg = qs + g * 4 * fw;
            const uint32_t qw[4] = {qg[wi], qg[fw + wi], qg[2 * fw + wi], qg[3 * fw + wi]};
            acc[i] += bsdp_word(qw, kw, is_signed);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int g = g0 + i;
        if (g < groups) {
          sc[g * slots + l] = static_cast<float>(acc[i]) * qsc_r[g] * kscale * sm_scale +
                              bias_r[static_cast<size_t>(g) * slots + l];
        }
      }
    }
  }
  __syncthreads();

  // 3. softmax over L, then fold v_scale into the weights
  for (int g = 0; g < groups; ++g) {
    float* row = sc + g * slots;
    float mx = -FLT_MAX;
    for (int l = threadIdx.x; l < slots; l += kThreads) mx = fmaxf(mx, row[l]);
    mx = block_reduce(mx, true, scratch);
    float sum = 0.f;
    for (int l = threadIdx.x; l < slots; l += kThreads) {
      const float p = expf(row[l] - mx);
      row[l] = p;
      sum += p;
    }
    sum = block_reduce(sum, false, scratch);
    for (int l = threadIdx.x; l < slots; l += kThreads) {
      row[l] = (row[l] / sum) * vs_row[l * s_l];
    }
  }
  __syncthreads();

  // 4. av against the raw V bits, plane values (1, 2, 4, ±8)
  const int feat = fw * 32;
  const int top = is_signed ? -8 : 8;
  for (int o = threadIdx.x; o < groups * feat; o += kThreads) {
    const int g = o / feat, f = o % feat;
    const int wi = f >> 5, bit = f & 31;
    const float* wrow = sc + g * slots;
    float acc = 0.f;
    for (int l = 0; l < slots; ++l) {
      const uint32_t* vl = v_row + l * p_l;
      const int val = static_cast<int>((vl[wi] >> bit) & 1u) +
                      2 * static_cast<int>((vl[fw + wi] >> bit) & 1u) +
                      4 * static_cast<int>((vl[2 * fw + wi] >> bit) & 1u) +
                      top * static_cast<int>((vl[3 * fw + wi] >> bit) & 1u);
      acc = fmaf(wrow[l], static_cast<float>(val), acc);
    }
    out[(static_cast<size_t>(r) * groups + g) * feat + f] = acc;
  }
}

}  // namespace

extern "C" int plane_decode_attention(const void* q, const void* q_scale, const void* kp,
                                      const void* k_scale, const void* vp,
                                      const void* v_scale, const void* bias, void* out,
                                      int batch, int heads, int groups, int slots, int fw,
                                      long long p_b, long long p_l, long long p_h,
                                      long long s_b, long long s_l, long long s_h,
                                      float sm_scale, int is_signed, void* stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || slots <= 0 || fw <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(groups) * slots * sizeof(float) +
                      static_cast<size_t>(groups) * 4 * fw * sizeof(uint32_t);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(plane_attn_kernel, smem);
  if (err != cudaSuccess) return err;
  plane_attn_kernel<<<batch * heads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const float*>(q_scale),
      static_cast<const uint32_t*>(kp), static_cast<const float*>(k_scale),
      static_cast<const uint32_t*>(vp), static_cast<const float*>(v_scale),
      static_cast<const float*>(bias), static_cast<float*>(out), heads, groups, slots, fw,
      p_b, p_l, p_h, s_b, s_l, s_h, sm_scale, is_signed);
  return static_cast<int>(cudaGetLastError());
}
