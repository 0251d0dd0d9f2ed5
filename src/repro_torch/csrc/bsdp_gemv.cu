// bsdp_gemv: bit-serial int4 dot products by AND + popcount (paper §IV,
// Algorithm 2): the M == 1 decode route of the bit-plane formats, and every
// M under w4a4_bsdp.
//
// Replaces: repro/kernels/bsdp_kernel.py:_bsdp_kernel (bsdp_matmul, the
// pallas_call at :94), the faithful UPMEM port, where lax.population_count
// plays UPMEM's `cao`.
//
//   out[m, n] = Σ_jk s_jk·2^(j+k)·Σ_w popcount(x[m, j, w] & wt[n, k, w])
//
// x [M, 4, Kw] and wt [N, 4, Kw] are 32-bit plane words, out [M, N] int32.
//
// Bound on the card: the weight planes' bytes, N·4·Kw·4 (12.6 MB at
// qwen3-1.7b's w_in: 0.0038 ms at 3.35 TB/s), read once per call; then the
// popcounts, 16 per weight word and row of x, on the CUDA cores (the
// binary mma.sync of bsdp_mma.cuh is the GEMMs' route; this one stays
// Algorithm 2).
//
// Design.  A column's K is cut into 16-byte slices (4 words of each of its 4
// plane rows); 16 lanes share a column, one slice each, so a pass covers 64
// words of K, a warp's load of one plane row is 256 contiguous bytes, and a
// block of 256 threads covers 16 columns of one row of x.  Every thread
// issues its 4 16-byte weight loads, and the next pass's while it
// contracts this one, and loads its slice of x (4 planes × 4 words, in
// registers) once a pass, at M = 1 also a pass ahead.  The 16 lanes of a
// column are summed by shuffles.  One block per 16 columns and row of x
// (768 at w_in, 128 at w_out; 3 or 4 resident blocks an SM) walks the
// whole K in passes (w_out: 3).  A ragged Kw or a weight or x that is not
// 16-byte aligned takes word loads (VEC = false) through the same code.
//
// At M > 1 (w4a4_bsdp) the blocks of the rows of x read the same weight,
// the first from device memory and the others mostly from L2 (12.6 MB at
// w_in fits its 50 MB).  There the route is bound by the integer issue
// rate of the popcounts, which wants many resident warps more than fewer
// weight reads: blocks that held a group of up to 4 rows in registers,
// applying each weight word to all of them, measured as fast at w_in and
// slower at w_out M = 4 (few column blocks, so few warps an SM).
//
// Variants tried on the card and not kept: two or four columns a thread,
// other resident-block counts, persistent blocks walking several column
// blocks, a K split over a thread-block cluster at w_out, two passes of
// loads in flight, row groups (above), and a carry-save adder network
// ahead of the popcounts (half as many): none was faster at M = 1, and the
// adder network only slightly at M = 256, where the integer issue rate,
// not the popcount unit, is the bound.  No shape of the serving paths
// leaves half of the SMs without a column block, where a K split could
// pay (w_out: 128 blocks at M = 1; wk/wv of w4a4_bsdp: 64 blocks but one
// pass of K).
//
// Grouped launch (the experts of a MoE layer at M = 1): the grid's third
// axis walks `groups` independent products of the same shape, stacked in
// memory — x [G, M, 4, Kw], wt [G, N, 4, Kw], out [G, M, N] — one launch
// for a layer's 64 expert projections.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                 // lanes sharing a column, a slice each
constexpr int kSlice = 4;                  // words of a plane row per slice
constexpr int kPass = kLanes * kSlice;     // words of K a block covers per pass
constexpr int kBN = kThreads / kLanes;     // columns a block covers


// XAHEAD (M = 1): the next pass's slice of x is loaded ahead with its
// weight, which hides its latency where the route is bound by latency and
// bytes, at 79 registers (3 resident blocks an SM).  At M > 1, bound by the
// integer issue rate, the registers buy a 4th resident block instead.
template <bool XAHEAD>
constexpr int kBlocksPerSM = XAHEAD ? 3 : 4;

// Words w .. w+3 of the plane row p, zero at and past `end`.
template <bool VEC>
__device__ __forceinline__ uint4 load_slice(const uint32_t* __restrict__ p, int w, int end) {
  if (VEC) {  // w % 4 == 0 and end % 4 == 0: the slice is wholly in or out
    return w < end ? __ldg(reinterpret_cast<const uint4*>(p + w)) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = w + e < end ? __ldg(p + w + e) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Σ over the slice's 4 word positions of Σ_jk s_jk·2^(j+k)·popcount(a_j & b_k).
template <bool SIGNED>
__device__ __forceinline__ int bsdp_slice(const uint4 (&a)[4], const uint4 (&b)[4]) {
  int acc = 0;
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    const uint32_t aw[4] = {word(a[0], e), word(a[1], e), word(a[2], e), word(a[3], e)};
    const uint32_t bw[4] = {word(b[0], e), word(b[1], e), word(b[2], e), word(b[3], e)};
    acc += bsdp_word(aw, bw, SIGNED);
  }
  return acc;
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) covers the kBN columns from
// blockIdx.x · kBN, in passes of kPass words of K, for row blockIdx.y of x
// in group blockIdx.z.
template <bool VEC, bool SIGNED, bool XAHEAD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM<XAHEAD>)
bsdp_gemv_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ wt,
                 int32_t* __restrict__ out, int m_rows, int n_cols, int kw) {
  x += static_cast<size_t>(blockIdx.z) * m_rows * 4 * kw;
  wt += static_cast<size_t>(blockIdx.z) * n_cols * 4 * kw;
  out += static_cast<size_t>(blockIdx.z) * m_rows * n_cols;
  const int lane = threadIdx.x % kLanes, col = threadIdx.x / kLanes;
  const int n = blockIdx.x * kBN + col;  // this thread's column
  const int m = blockIdx.y;
  const int passes = (kw + kPass - 1) / kPass;
  const size_t ps = static_cast<size_t>(kw);  // words between plane rows
  const uint32_t* wr = wt + static_cast<size_t>(min(n, n_cols - 1)) * 4 * ps;
  const uint32_t* xr = x + static_cast<size_t>(m) * 4 * ps;
  const int w_lim = n < n_cols ? kw : 0;
  auto load = [&](uint4 (&v)[4], const uint32_t* row, int p, int end) {
    const int w0 = p * kPass + lane * kSlice;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load_slice<VEC>(row + j * ps, w0, end);
  };

  // The next pass's weight loads (and with XAHEAD its slice of x) are in
  // flight while this pass is contracted; the slice of x is loaded once a
  // pass.
  uint4 a[4], b[4], na[4], nb[4];
  load(b, wr, 0, w_lim);
  if (XAHEAD) load(a, xr, 0, kw);
  int acc = 0;
  for (int p = 0; p < passes; ++p) {
    if (p + 1 < passes) {
      load(nb, wr, p + 1, w_lim);
      if (XAHEAD) load(na, xr, p + 1, kw);
    }
    if (!XAHEAD) load(a, xr, p, kw);
    acc += bsdp_slice<SIGNED>(a, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = nb[j];
      if (XAHEAD) a[j] = na[j];
    }
  }
  // the column's 16 lanes
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);

  if (lane == 0 && n < n_cols) out[static_cast<size_t>(m) * n_cols + n] = acc;
}

template <bool VEC, bool SIGNED, bool XAHEAD>
cudaError_t launch(const uint32_t* x, const uint32_t* wt, int32_t* out, int groups, int m, int n,
                   int kw, cudaStream_t stream) {
  // one block per kBN columns, row of x and group
  const dim3 grid((n + kBN - 1) / kBN, m, groups);
  bsdp_gemv_kernel<VEC, SIGNED, XAHEAD><<<grid, kThreads, 0, stream>>>(x, wt, out, m, n, kw);
  return cudaGetLastError();
}

template <bool VEC, bool SIGNED>
cudaError_t launch_for_m(const uint32_t* x, const uint32_t* wt, int32_t* out, int groups, int m,
                         int n, int kw, cudaStream_t stream) {
  if (m == 1) return launch<VEC, SIGNED, true>(x, wt, out, groups, m, n, kw, stream);
  return launch<VEC, SIGNED, false>(x, wt, out, groups, m, n, kw, stream);
}

}  // namespace

// groups = 1: one [M, 4, Kw] x [N, 4, Kw] product; groups = G: G of them
// stacked (the experts of a MoE layer), one launch.
extern "C" int bsdp_gemv(const void* x, const void* wt, void* out, int groups, int m, int n,
                         int kw, int is_signed, void* stream) {
  if (m <= 0 || n <= 0 || kw <= 0 || m > 65535 || groups <= 0 || groups > 65535)
    return cudaErrorInvalidValue;
  const auto xp = static_cast<const uint32_t*>(x);
  const auto wp = static_cast<const uint32_t*>(wt);
  const auto op = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = kw % kSlice == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  cudaError_t err;
  if (vec)
    err = is_signed ? launch_for_m<true, true>(xp, wp, op, groups, m, n, kw, s)
                    : launch_for_m<true, false>(xp, wp, op, groups, m, n, kw, s);
  else
    err = is_signed ? launch_for_m<false, true>(xp, wp, op, groups, m, n, kw, s)
                    : launch_for_m<false, false>(xp, wp, op, groups, m, n, kw, s);
  return static_cast<int>(err);
}
