// dequant_matmul: W8A16 weight-only matmul with the dequantize fused in.
//
// Replaces: repro/kernels/dequant_gemv.py:_dequant_matmul_kernel
// (dequant_matmul, :46).
//
//   out[m, n] = (Σ_k float(x[m, k]) · float(w[k, n])) · w_scale[n]
//
// x [M, K] float32 or bfloat16, w [K, N] int8, w_scale [N] float32 → out
// [M, N] float32.  Both operands are widened to float32 in registers (exact)
// and summed in float32 — never TF32 — so either x type keeps the
// reference's numbers.  The dequantized weight never exists in memory.
//
// Two routes, by M:
//
// decode (M <= 16) — bound by the int8 weight's K·N bytes.  The weight has
//   to be requested almost all at once to stream at the card's rate, so K is
//   split over a thread-block cluster of up to 8 blocks (grid N/64 × splits:
//   32 × 8 at N = 2048, K = 2048; at M = 1, whose blocks do few products, 32
//   × 4 when 32 × 8 would not fit in one wave of a block per SM).  A block owns 64 columns × K/splits rows;
//   each thread issues all of its 16-byte weight loads (R = 4 or 8 rows × 16
//   columns; a warp reads 8 rows × 64 contiguous bytes) before it
//   uses any, then stages the activation slice, widens each int8 by a byte
//   permute and one subtraction, and accumulates 16 column partials per row
//   of x that a butterfly of shuffles reduces over the warp's 8 row lanes.
//   The 8 warps' partials are summed in a fixed order in shared memory, then
//   the cluster's K splits in rank order through distributed shared memory;
//   the scale is applied once.  One launch, no workspace in device memory,
//   no atomics: deterministic.
//
// prefill (M > 16) — bound by the 2·M·N·K float32 multiply-adds.  64 × 64
//   output tiles, 4 × 4 per thread; the raw activation and int8 weight tiles
//   (32 deep) are staged by 16-byte cp.async in a ring of 3 stages, so two
//   tiles' copies are in flight while one is multiplied; each tile is
//   widened once into float32 shared memory (the activation tile
//   transposed, its raw rows swizzled so the transposing reads do not
//   conflict).  One block of 8 warps per output tile cannot hide the shared
//   memory latency, so K is split over a cluster of up to 8 blocks until the
//   grid holds about 4 blocks per SM; the splits' tiles are summed in rank
//   order through distributed shared memory, as on the decode route.  Ragged
//   or unaligned shapes stage element by element instead of by cp.async.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// decode route
constexpr int kDecBN = 64;              // columns per block: 4 threads × 16
constexpr int kDecRows = kThreads / 4;  // K rows per load round
constexpr int kMaxSplits = 8;           // portable cluster size
constexpr int kRowGroup = 4;            // rows of x accumulated per pass

// prefill route
constexpr int kPreBM = 64, kPreBN = 64, kPreBK = 32;
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kPrefillBlocksPerSM = 4;  // K splits until about this many blocks per SM

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 16-byte chunk of x, widened: 4 float32 or 8 bfloat16 values (a
// bfloat16 is the top half of its float32, so the widening is exact).
__device__ __forceinline__ void widen_chunk(uint4 u, float* v, float) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen_chunk(uint4 u, float* v, __nv_bfloat16) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// Byte j of `word` as a signed int8, widened exactly: the byte, offset by
// 128 (xor 0x80), becomes the low mantissa bits of 2^23, and 2^23 + 128 is
// subtracted — a byte permute and an add instead of an int → float convert.
__device__ __forceinline__ float byte_f32(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7540 | j)) -
         8388736.0f;
}

// 16 int8 weights w[k, n .. n+15] (zeros outside the matrix).
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w, int k, bool k_ok,
                                          int n, int n_cols) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!k_ok || n >= n_cols) return r;
  const int8_t* p = w + static_cast<size_t>(k) * n_cols + n;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (n + c < n_cols) b[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[c])) << (8 * (c & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

// Keep half of `v` (the half picked by `upper`), adding the partner lane's
// copy of it: a reduce-scatter step over lanes `mask` apart.
template <int HALF>
__device__ __forceinline__ void butterfly_step(float* v, int mask, bool upper) {
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float send = upper ? v[c] : v[c + HALF];
    const float keep = upper ? v[c + HALF] : v[c];
    v[c] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

template <int MT, int R, bool VEC, typename XT>
__global__ void __launch_bounds__(kThreads, 2)
dequant_decode_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ w_scale, float* __restrict__ out,
                      int m_rows, int n_cols, int k_dim, int k_per_split) {
  constexpr int kKC = kDecRows * R;  // K rows per chunk
  constexpr int kMG = MT < kRowGroup ? MT : kRowGroup;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [MT][kKC] widened x slice
  float* red = xs + MT * kKC;                   // [kWarps][MT][kDecBN] warp partials
  float* part = red + kWarps * MT * kDecBN;     // [MT][kDecBN] this block's K split

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid >> 2;                    // K row within a load round
  const int n0 = blockIdx.x * kDecBN;
  const int ncol = n0 + (tid & 3) * 16;        // this thread's 16 weight columns
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(k_dim, k_begin + k_per_split);
  // the 2 columns this lane holds after the butterfly over lane bits 4, 3, 2
  const int ocol = (tid & 3) * 16 + ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                   ((lane >> 2) & 1) * 2;
  float* my_red = red + warp * MT * kDecBN + ocol;
#pragma unroll
  for (int m = 0; m < MT; ++m) my_red[m * kDecBN] = my_red[m * kDecBN + 1] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kKC) {
    // every weight load of the chunk in flight before any is used
    uint4 raw[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = k0 + row + i * kDecRows;
      raw[i] = load_w16<VEC>(w, k, k < k_end, ncol, n_cols);
    }
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int idx = tid; idx < m_rows * kKC; idx += kThreads) {
      const int m = idx / kKC, k = k0 + idx % kKC;
      xs[idx] = k < k_end ? widen(x[static_cast<size_t>(m) * k_dim + k]) : 0.f;
    }
    __syncthreads();
    for (int mg = 0; mg < m_rows; mg += kMG) {  // uniform across the block
      float p[kMG][16];
#pragma unroll
      for (int mm = 0; mm < kMG; ++mm)
#pragma unroll
        for (int c = 0; c < 16; ++c) p[mm][c] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        uint32_t words[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
        // widen inside the pass: hoisted out of the row-group loop, all R·16
        // widened weights would be live at once and spill
        asm volatile("" : "+r"(words[0]), "+r"(words[1]), "+r"(words[2]), "+r"(words[3]));
        float wf[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) wf[c] = byte_f32(words[c >> 2], c & 3);
#pragma unroll
        for (int mm = 0; mm < kMG; ++mm) {
          if (mg + mm < m_rows) {
            const float xv = xs[(mg + mm) * kKC + row + i * kDecRows];
#pragma unroll
            for (int c = 0; c < 16; ++c) p[mm][c] = fmaf(xv, wf[c], p[mm][c]);
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < kMG; ++mm) {
        if (mg + mm < m_rows) {
          butterfly_step<8>(p[mm], 16, lane & 16);
          butterfly_step<4>(p[mm], 8, lane & 8);
          butterfly_step<2>(p[mm], 4, lane & 4);
          my_red[(mg + mm) * kDecBN] += p[mm][0];
          my_red[(mg + mm) * kDecBN + 1] += p[mm][1];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < m_rows * kDecBN; idx += kThreads) {
    float s = 0.f;
    for (int wv = 0; wv < kWarps; ++wv) s += red[wv * MT * kDecBN + idx];
    part[idx] = s;
  }
  cluster.sync();  // every split's part is written
  // this block's share of the tile's outputs, summed over the splits in rank order
  const int splits = static_cast<int>(cluster.num_blocks());
  const int total = m_rows * kDecBN;
  const int per = (total + splits - 1) / splits;
  for (int i = tid; i < per; i += kThreads) {
    const int idx = static_cast<int>(cluster.block_rank()) * per + i;
    if (idx >= total) break;
    const int gn = n0 + idx % kDecBN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) s += cluster.map_shared_rank(part, q)[idx];
    if (gn < n_cols) out[static_cast<size_t>(idx / kDecBN) * n_cols + gn] = s * w_scale[gn];
  }
  cluster.sync();  // no block leaves while another still reads its part
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool ALIGNED, typename XT>
__global__ void __launch_bounds__(kThreads, 3)
dequant_prefill_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale, float* __restrict__ out,
                       int m_rows, int n_cols, int k_dim, int tiles_per_split) {
  constexpr int kEpc = 16 / sizeof(XT);          // x elements per 16-byte chunk
  constexpr int kCpr = kPreBK / kEpc;            // chunks per raw x row (8 or 4)
  constexpr int kSwz = 8 / kCpr;                 // rows sharing one swizzle value
  constexpr int kXBytes = kPreBM * kPreBK * sizeof(XT);
  constexpr int kWBytes = kPreBK * kPreBN;
  constexpr int kStageBytes = kXBytes + kWBytes;
  extern __shared__ float4 smem4[];
  float(*xs)[kPreBM] = reinterpret_cast<float(*)[kPreBM]>(smem4);  // [kPreBK] widened x, k-major
  float(*ws)[kPreBN] = reinterpret_cast<float(*)[kPreBN]>(&xs[kPreBK][0]);  // [kPreBK] widened w
  unsigned char* ring = reinterpret_cast<unsigned char*>(&ws[kPreBK][0]);  // [kStages] raw tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kPreBM, n0 = blockIdx.x * kPreBN;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // 4-row group, 0..15
  const int tx = (warp & 1) * 8 + (lane & 7);    // 4-column group, 0..15

  // raw x row r holds its chunk c at position c ^ swz(r)
  auto stage = [&](int buf, int k0) {
    XT* rx = reinterpret_cast<XT*>(ring + buf * kStageBytes);
    int8_t* rw = reinterpret_cast<int8_t*>(ring + buf * kStageBytes + kXBytes);
    for (int ch = tid; ch < kPreBM * kCpr; ch += kThreads) {
      const int r = ch / kCpr, c = ch % kCpr;
      const int gm = m0 + r, gk = k0 + c * kEpc;
      XT* dst = rx + r * kPreBK + ((c ^ ((r / kSwz) % kCpr)) * kEpc);
      if (ALIGNED) {
        const int valid = gm < m_rows ? max(0, min(kEpc, k_dim - gk)) : 0;
        const XT* src = valid ? x + static_cast<size_t>(gm) * k_dim + gk : x;
        cp_async16(dst, src, valid * static_cast<int>(sizeof(XT)));
      } else {
#pragma unroll
        for (int e = 0; e < kEpc; ++e)
          dst[e] = (gm < m_rows && gk + e < k_dim) ? x[static_cast<size_t>(gm) * k_dim + gk + e]
                                                   : XT(0.f);
      }
    }
    for (int ch = tid; ch < kPreBK * (kPreBN / 16); ch += kThreads) {
      const int r = ch / (kPreBN / 16), c = ch % (kPreBN / 16);
      const int gk = k0 + r, gn = n0 + c * 16;
      int8_t* dst = rw + r * kPreBN + c * 16;
      if (ALIGNED) {
        const int valid = gk < k_dim ? max(0, min(16, n_cols - gn)) : 0;
        const int8_t* src = valid ? w + static_cast<size_t>(gk) * n_cols + gn : w;
        cp_async16(dst, src, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (gk < k_dim && gn + e < n_cols) ? w[static_cast<size_t>(gk) * n_cols + gn + e]
                                                   : int8_t(0);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // this block's K split: tiles [t0, t0 + ktiles)
  const int t0 = blockIdx.z * tiles_per_split;
  const int ktiles = max(0, min(tiles_per_split, (k_dim + kPreBK - 1) / kPreBK - t0));
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ktiles) stage(t, (t0 + t) * kPreBK);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    const int ahead = t + kStages - 1;  // its slot was widened in iteration t - 1
    if (ahead < ktiles) stage(ahead % kStages, (t0 + ahead) * kPreBK);
    cp_async_commit();  // possibly empty: keeps the group count in step with the tiles
    cp_async_wait<kStages - 1>();  // this thread's copies of tile t have landed
    __syncthreads();               // ... and every thread's
    // widen once: x transposed to k-major, w as it lies
    const unsigned char* slot = ring + (t % kStages) * kStageBytes;
    const XT* rx = reinterpret_cast<const XT*>(slot);
    const int8_t* rw = reinterpret_cast<const int8_t*>(slot + kXBytes);
    for (int ch = tid; ch < kPreBM * kCpr; ch += kThreads) {
      const int r = ch % kPreBM, c = ch / kPreBM;  // consecutive lanes: consecutive rows
      const XT* src = rx + r * kPreBK + ((c ^ ((r / kSwz) % kCpr)) * kEpc);
      float v[kEpc];
      widen_chunk(*reinterpret_cast<const uint4*>(src), v, XT());
#pragma unroll
      for (int e = 0; e < kEpc; ++e) xs[c * kEpc + e][r] = v[e];
    }
    for (int ch = tid; ch < kPreBK * kPreBN / 8; ch += kThreads) {
      const int r = ch / (kPreBN / 8), c = (ch % (kPreBN / 8)) * 8;
      const uint2 q = *reinterpret_cast<const uint2*>(rw + r * kPreBN + c);
      *reinterpret_cast<float4*>(&ws[r][c]) =
          make_float4(byte_f32(q.x, 0), byte_f32(q.x, 1), byte_f32(q.x, 2), byte_f32(q.x, 3));
      *reinterpret_cast<float4*>(&ws[r][c + 4]) =
          make_float4(byte_f32(q.y, 0), byte_f32(q.y, 1), byte_f32(q.y, 2), byte_f32(q.y, 3));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kPreBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // this split's tile into shared memory (over the widened tiles, now unused)
  cg::cluster_group cluster = cg::this_cluster();
  cp_async_wait<0>();
  __syncthreads();
  float* part = &xs[0][0];  // [kPreBM][kPreBN]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&part[(ty * 4 + i) * kPreBN + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();  // every split's part is written
  const int splits = static_cast<int>(cluster.num_blocks());
  const int per = (kPreBM * kPreBN + splits - 1) / splits;
  for (int i = tid; i < per; i += kThreads) {
    const int idx = static_cast<int>(cluster.block_rank()) * per + i;
    if (idx >= kPreBM * kPreBN) break;
    const int gm = m0 + idx / kPreBN, gn = n0 + idx % kPreBN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) s += cluster.map_shared_rank(part, q)[idx];
    if (gm < m_rows && gn < n_cols) out[static_cast<size_t>(gm) * n_cols + gn] = s * w_scale[gn];
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// Streaming multiprocessors of the current device, queried once per device.
cudaError_t sm_count(int* count) {
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *count = counts[dev];
  return cudaSuccess;
}

template <int MT, int R, bool VEC, typename XT>
cudaError_t launch_decode(const XT* x, const int8_t* w, const float* s, float* out, int m,
                          int n, int k, cudaStream_t stream) {
  constexpr int kKC = kDecRows * R;
  const int splits = std::min(kMaxSplits, (k + kKC - 1) / kKC);
  const int k_per_split = (k + splits - 1) / splits;
  auto kernel = dequant_decode_kernel<MT, R, VEC, XT>;
  const size_t smem = sizeof(float) * (MT * kKC + kWarps * MT * kDecBN + MT * kDecBN);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kDecBN - 1) / kDecBN, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, s, out, m, n, k, k_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Rows of weight loads in flight per thread: 4 (8 K splits), or at M = 1,
// where a block's products are few, 8 (4 splits, twice the bytes per block)
// when the 4-row grid would not fit in one wave of a block per SM.
template <bool VEC, typename XT>
cudaError_t decode_for_m(const XT* x, const int8_t* w, const float* s, float* out, int m,
                         int n, int k, cudaStream_t stream) {
  if (m <= 1) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const long long blocks4 = static_cast<long long>((n + kDecBN - 1) / kDecBN) *
                              std::min(kMaxSplits, (k + 4 * kDecRows - 1) / (4 * kDecRows));
    if (blocks4 > sms) return launch_decode<1, 8, VEC>(x, w, s, out, m, n, k, stream);
    return launch_decode<1, 4, VEC>(x, w, s, out, m, n, k, stream);
  }
  if (m <= 4) return launch_decode<4, 4, VEC>(x, w, s, out, m, n, k, stream);
  return launch_decode<16, 4, VEC>(x, w, s, out, m, n, k, stream);
}

template <bool ALIGNED, typename XT>
cudaError_t launch_prefill(const XT* x, const int8_t* w, const float* s, float* out, int m,
                           int n, int k, cudaStream_t stream) {
  const int gx = (n + kPreBN - 1) / kPreBN, gy = (m + kPreBM - 1) / kPreBM;
  if (gy > 65535) return cudaErrorInvalidValue;
  const int ktiles = (k + kPreBK - 1) / kPreBK;
  const long long tiles2d = static_cast<long long>(gx) * gy;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int splits = static_cast<int>(std::min<long long>(
      std::min(kMaxSplits, ktiles), std::max<long long>(1, kPrefillBlocksPerSM * sms / tiles2d)));
  const int tiles_per_split = (ktiles + splits - 1) / splits;
  splits = (ktiles + tiles_per_split - 1) / tiles_per_split;  // no empty split
  const size_t smem = sizeof(float) * kPreBK * (kPreBM + kPreBN) +
                      kStages * (kPreBM * kPreBK * sizeof(XT) + kPreBK * kPreBN);
  auto kernel = dequant_prefill_kernel<ALIGNED, XT>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, s, out, m, n, k, tiles_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch(const void* xv, const void* wv, const void* sv, void* ov, int m, int n,
                     int k, cudaStream_t stream) {
  const XT* x = static_cast<const XT*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* s = static_cast<const float*>(sv);
  float* out = static_cast<float*>(ov);
  const bool w_vec = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (m <= 16) {
    return w_vec ? decode_for_m<true>(x, w, s, out, m, n, k, stream)
                 : decode_for_m<false>(x, w, s, out, m, n, k, stream);
  }
  const bool aligned = w_vec && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       ((static_cast<size_t>(k) * sizeof(XT)) % 16 == 0);
  return aligned ? launch_prefill<true>(x, w, s, out, m, n, k, stream)
                 : launch_prefill<false>(x, w, s, out, m, n, k, stream);
}

}  // namespace

// x_bf16: 0 = x is float32, 1 = x is bfloat16.
extern "C" int dequant_matmul(const void* x, const void* w, const void* w_scale, void* out,
                              int m, int n, int k, int x_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = x_bf16 ? dispatch<__nv_bfloat16>(x, w, w_scale, out, m, n, k, st)
                                 : dispatch<float>(x, w, w_scale, out, m, n, k, st);
  return static_cast<int>(err);
}
