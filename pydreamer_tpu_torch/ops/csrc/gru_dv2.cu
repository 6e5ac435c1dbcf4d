// Fused DreamerV2 late-reset GRU cell forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pydreamer_tpu/ops/gru_pallas.py::_kernel
// (launched by _forward, gru_pallas.py:73-84). One GRU step:
//
//   gates = x @ w_ih + h @ w_hh            bf16 operands, f32 accumulation
//   gates = LayerNorm(gates) * scale + bias over all 3H columns, eps 1e-3
//   r, u, n = split(gates)
//   h' = sigmoid(u-1) * tanh(sigmoid(r) * n) + (1 - sigmoid(u-1)) * h   (f32)
//
// Shapes: x (M,In), h (M,H), w_ih (In,3H), w_hh (H,3H) in bf16, row-major and
// contiguous; scale, bias (3H) f32; out (M,H) f32. At the flagship config
// In=1000, H=1024 and M=32 (posterior scan) or M=1536 (dream scan).
//
// What bounds it on an H100: at M=32 the 12.4 MB of bf16 weights must stream
// from device memory once per launch (bytes); at M=1536 the 19.1 GFLOP of the
// two products (operations). LayerNorm couples all 3H columns of a row, so no
// single block can hold a row's gates on chip at H=1024.
//
// Design (simple and correct first): two kernels on the caller's stream.
//   1. gates_kernel: tiled bf16 GEMM on the tensor cores (WMMA 16x16x16, f32
//      accumulate), 64x64 output tile per 4-warp block. It walks K over
//      x.w_ih and then over h.w_hh into the same accumulators, so the two
//      products need no concatenation, and writes the f32 gates to a
//      workspace. Tiles are bounds-checked (zero fill), so any M, In and H work.
//   2. ln_gate_kernel: one block per row; mean and variance over 3H (two
//      passes, as the reference), scale/bias, the gate math and the f32 h'.
// The gates round trip through device memory ((M,3H) f32) and the GEMM does
// not pipeline its loads; both are for later work (wgmma/TMA, split-N with
// per-row partial sums, cluster reductions).
//
// Plain C interface, loaded with ctypes: each entry returns the CUDA error
// code of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;             // rows of the output tile
constexpr int BN = 64;             // gate columns of the output tile
constexpr int BK = 32;             // depth of one shared-memory stage
constexpr int WARPS_N = 2;         // 2x2 warps, each owning a 32x32 sub-tile
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;       // padded leading dims (multiples of 8 for
constexpr int B_LD = BN + 8;       // 16-bit WMMA loads, of 4 for f32 stores,
constexpr int C_LD = BN + 4;       // every fragment start 32-byte aligned)
constexpr int ROW_THREADS = 256;   // block size of the LayerNorm/gate pass

// Copy 8 consecutive bf16 of one row into shared memory, zero outside
// [0, ncols) or when the row itself is out of range.
__device__ __forceinline__ void load_chunk8(bf16* dst, const bf16* row, int col,
                                            int ncols, bool row_ok) {
  const bf16* src = row + col;
  if (row_ok && col + 8 <= ncols && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[i] = (row_ok && col + i < ncols) ? src[i] : __float2bfloat16(0.0f);
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += A[m0:m0+BM, :K] @ B[:K, n0:n0+BN] with A (M,K) and B (K,N) row-major.
__device__ __forceinline__ void mma_phase(const bf16* __restrict__ A,
                                          const bf16* __restrict__ B, int M,
                                          int K, int N, int m0, int n0,
                                          bf16* As, bf16* Bs, FragC (&acc)[2][2]) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = threadIdx.x; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gm = m0 + r;
      load_chunk8(&As[r * A_LD + cc], A + (size_t)gm * K, k0 + cc, K, gm < M);
    }
    for (int c = threadIdx.x; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const int gk = k0 + r;
      load_chunk8(&Bs[r * B_LD + cc], B + (size_t)gk * N, n0 + cc, N, gk < K);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
gates_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
             const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh,
             float* __restrict__ gates, int M, int In, int H) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  const int N = 3 * H;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  mma_phase(x, w_ih, M, In, N, m0, n0, As, Bs, acc);
  mma_phase(h, w_hh, M, H, N, m0, n0, As, Bs, acc);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    if (m0 + r < M && n0 + c < N) gates[(size_t)(m0 + r) * N + n0 + c] = Cs[r * C_LD + c];
  }
}

// Sum over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < ROW_THREADS / 32; ++w) total += red[w];
  __syncthreads();  // red is reused by the next call
  return total;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__global__ void __launch_bounds__(ROW_THREADS)
ln_gate_kernel(const float* __restrict__ gates, const bf16* __restrict__ h,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ out, int H) {
  __shared__ float red[ROW_THREADS / 32];
  const int N = 3 * H;
  const size_t row = blockIdx.x;
  const float* g = gates + row * N;

  float s = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) s += g[j];
  const float mean = block_sum(s, red) / N;
  float v = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    const float d = g[j] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / N + 1e-3f);

  for (int j = threadIdx.x; j < H; j += ROW_THREADS) {
    const float r = (g[j] - mean) * rstd * scale[j] + bias[j];
    const float u = (g[H + j] - mean) * rstd * scale[H + j] + bias[H + j];
    const float n = (g[2 * H + j] - mean) * rstd * scale[2 * H + j] + bias[2 * H + j];
    const float update = sigmoid(u - 1.0f);
    const float newval = tanhf(sigmoid(r) * n);
    const float hv = __bfloat162float(h[row * H + j]);
    out[row * H + j] = update * newval + (1.0f - update) * hv;
  }
}

}  // namespace

extern "C" int gru_dv2_forward(const void* x, const void* h, const void* w_ih,
                               const void* w_hh, const void* scale,
                               const void* bias, void* gates, void* out, int M,
                               int In, int H, void* stream) {
  if (M <= 0 || In <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((3 * H + BN - 1) / BN, (M + BM - 1) / BM);
  gates_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(h),
      static_cast<const bf16*>(w_ih), static_cast<const bf16*>(w_hh),
      static_cast<float*>(gates), M, In, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_gate_kernel<<<M, ROW_THREADS, 0, s>>>(
      static_cast<const float*>(gates), static_cast<const bf16*>(h),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), H);
  return (int)cudaGetLastError();
}

extern "C" const char* gru_dv2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
