// dequant_matmul: W8A16 weight-only matmul with the dequantize fused in.
//
// Replaces: repro/kernels/dequant_gemv.py:_dequant_matmul_kernel
// (dequant_matmul, :46).
//
//   out[m, n] = (Σ_k x[m, k] · float(w[k, n])) · w_scale[n]
//
// x [M, K] float32, w [K, N] int8, w_scale [N] float32 → out [M, N] float32.
//
// Bound on the card: at decode (M = 1 or the slot count) the int8 weight,
// K·N bytes, read once from device memory; at prefill (M in the hundreds)
// the 2·M·N·K float32 multiply-adds on the CUDA cores (float32, not TF32:
// the port keeps the reference's float32 accumulation).  Design: the int8
// weight is loaded as int8 (4 columns per 32-bit load) and widened to float
// in registers; the dequantized weight never exists in device memory.  A
// block owns 32 columns × 8 rows of the output; its 256 threads split K
// into 32 interleaved slices, each accumulating in float32 registers, and
// the slices are summed in a fixed order in shared memory (deterministic),
// then the per-channel scale is applied in the epilogue.  The activation
// rows are staged in shared memory in K chunks of 256.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColGroups = 8;               // threads across the columns
constexpr int kBN = kColGroups * 4;         // 32 output columns per block
constexpr int kKSlices = kThreads / kColGroups;  // 32 K slices per block
constexpr int kBM = 8;                      // output rows per block
constexpr int kKC = 256;                    // K chunk staged in shared memory

__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ w_scale, float* __restrict__ out,
                      int m_rows, int n_cols, int k_dim, int vec4) {
  __shared__ float xs[kBM][kKC];
  __shared__ float red[kKSlices][kBM][kBN];
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int ks = tid / kColGroups;
  const int m0 = blockIdx.y * kBM;
  const int n = blockIdx.x * kBN + cg * 4;
  const bool vec = vec4 && (n + 3 < n_cols);

  float acc[kBM][4];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k_dim; k0 += kKC) {
    for (int i = tid; i < kBM * kKC; i += kThreads) {
      const int r = i / kKC, kk = i % kKC;
      const int gm = m0 + r, gk = k0 + kk;
      xs[r][kk] = (gm < m_rows && gk < k_dim) ? x[static_cast<size_t>(gm) * k_dim + gk] : 0.f;
    }
    __syncthreads();
    const int kend = min(kKC, k_dim - k0);
    for (int kk = ks; kk < kend; kk += kKSlices) {
      const int8_t* wrow = w + static_cast<size_t>(k0 + kk) * n_cols;
      float wv[4];
      if (vec) {
        const char4 q = *reinterpret_cast<const char4*>(wrow + n);
        wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[c] = (n + c < n_cols) ? static_cast<float>(wrow[n + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ks][r][cg * 4 + c] = acc[r][c];
  __syncthreads();
  for (int o = tid; o < kBM * kBN; o += kThreads) {
    const int r = o / kBN, c = o % kBN;
    const int gm = m0 + r, gn = blockIdx.x * kBN + c;
    if (gm >= m_rows || gn >= n_cols) continue;
    float s = 0.f;
    for (int i = 0; i < kKSlices; ++i) s += red[i][r][c];
    out[static_cast<size_t>(gm) * n_cols + gn] = s * w_scale[gn];
  }
}

}  // namespace

extern "C" int dequant_matmul(const void* x, const void* w, const void* w_scale, void* out,
                              int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const int vec4 = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  dequant_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<float*>(out), m, n, k, vec4);
  return static_cast<int>(cudaGetLastError());
}
