// Kernel K1: the fused DreamerV2 late-reset GRU cell forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pydreamer_tpu/ops/gru_pallas.py::_kernel
// (launched by _forward, gru_pallas.py:73-84). One GRU step:
//
//   gates = x @ w_ih + h @ w_hh            f32 accumulation
//   gates = LayerNorm(gates) * scale + bias over all 3H columns, eps 1e-3
//   r, u, n = split(gates)
//   h' = sigmoid(u-1) * tanh(sigmoid(r) * n) + (1 - sigmoid(u-1)) * h   (f32)
//
// Shapes: x (M,In), h (M,H), w_ih (In,3H), w_hh (H,3H), all bf16 or all f32,
// row-major and contiguous; scale, bias (3H) f32; out (M,H) f32. At the
// flagship config In=1000, H=1024 and M=32 (posterior scan, 48 launches a
// train step) or M=1536 (dream scan, 15 launches a train step).
//
// One C entry point, six schedules. The wrapper (ops/gru_dv2.py, plan())
// picks one from (M, In, H, dtype) alone. All six replace the one Pallas
// kernel _kernel (gru_pallas.py:49-84) and nothing else of JAX:
//
// * skinny (bf16, M <= 64, In % 8 == 0, H % 64 == 0). Bound by bytes: at
//   M=32 the 12.4 MB of bf16 weights must stream from device memory once;
//   the products are ~0.4 GFLOP. Split-N x split-K: 64 gate columns x at
//   most 512 rows of [w_ih; w_hh] per block (192 blocks at the flagship
//   shape, more than the 132 SMs), each streaming its weight slab through a
//   16-stage cp.async ring (64 KB in flight per block) into mma.sync
//   m16n8k16; the activations of its K range sit in shared memory whole.
//   Partial gates (nsplit x M x 3H f32, 1.6 MB) go to a workspace and
//   ln_gate_kernel sums them, normalises and applies the gates.
// * wide (bf16, M > 64, In % 8 == 0, H % 128 == 0). Bound by operations:
//   19.1 GFLOP at M=1536. Warp-specialised wgmma: one producer warp keeps a
//   5-stage TMA ring full (swizzled tiles, mbarriers), two consumer
//   warpgroups run wgmma m64n128k16 with the weights as the MN-major B
//   operand. Each block owns 128 rows and the SAME 128 hidden units in all
//   three gates (columns [jHB, (j+1)HB), H + ..., 2H + ...), so the gate
//   math needs no other block. K walks over x.w_ih (TMA zero-fills the
//   ragged last tile, In=1000) and then h.w_hh into the same accumulators.
//   When H/128 <= 8 the blocks of a row tile form one thread-block cluster:
//   each computes per-row (mean, M2) over its 384 columns, the cluster
//   combines them over distributed shared memory with Chan's formula (the
//   two-pass accuracy of the reference), and the epilogue writes only h'.
//   Wider H (H/128 > 8, e.g. H=2048) writes the f32 gates to the workspace
//   and ln_gate_kernel finishes, as the split-N design does. DreamerV3 XL
//   (In=1024, H=4096) runs skinny at M=16 in ten K slices of 512 rows
//   (1,920 blocks) and wide at M=1024 through the 50 MB workspace.
// * generic (bf16, any other shape, e.g. In=37 or H=50): a WMMA 16x16x16
//   GEMM with bounds-checked tiles writing f32 gates, then ln_gate_kernel.
// * skinny_f32 (f32, M <= 64, In % 4 == 0, H % 4 == 0). Bound by bytes:
//   24.9 MB of f32 weights at the flagship shape (0.0076 ms at 3.35 TB/s).
//   skinny's split-N x split-K design with 16-byte cp.async into a 4-stage
//   ring of 8 KB f32 tiles and at most 256 weight rows per block, so that
//   blocks stay small (70 KB at M <= 32) and three fit an SM: 384 blocks at
//   the flagship shape, all in flight at once. Products in 3xTF32 (below),
//   partial gates to the workspace, then ln_gate_kernel.
// * wide_f32 (f32, M > 64, In % 4 == 0, H % 4 == 0). Bound by operations:
//   19.1 GFLOP at M=1536, which 3xTF32 makes 57.3 GFLOP of TF32 (0.116 ms
//   at the 495 TFLOP/s dense TF32 rate; 0.285 ms for FFMA at 67 TFLOP/s).
//   A 128 (or 64) x 96 tile per 8-warp block over a 4-stage cp.async ring of
//   32-deep slices, mma.sync in 3xTF32, each slice's sums added into f32
//   totals, f32 gates to the workspace, then ln_gate_kernel (2 x 18.9 MB at
//   M=1536). Three mma.sync per product, not the split, set its time: with
//   the split left out, the same tiles take most of it.
//   Why mma.sync and not wgmma: for .tf32 the PTX ISA takes both wgmma
//   operands K-major in shared memory (the transpose qualifiers exist for
//   16-bit types only), and the weights arrive (In, 3H) row-major, MN-major
//   as B. wgmma would need a K-major copy of the weights, made once per
//   optimizer step; mma.sync takes B from registers, loaded from the
//   MN-major tile as it lies.
// * f32 (f32, any other shape, e.g. In=37 or H=50): a SIMT FFMA GEMM in
//   full f32, then ln_gate_kernel. The first f32 design: one 64x64 tile per
//   256-thread block, synchronous scalar loads, kept unchanged for the
//   shapes the two above do not take.
//
// 3xTF32: each f32 operand is split into a TF32 high part and a TF32 low
// part (rounded as cvt.rna rounds), and three tensor-core products, the two
// small ones first, sum to close to f32 accuracy (section tf32x3 below). A
// single TF32 pass keeps ~3 digits, short of the f32 path's 1e-4 tolerance
// on h'.
//
// The backward (bf16 operands; GRUDv2Function.backward's bf16 pass in
// ops/gru_dv2.py, section k1_bwd below) has two more entries:
// gru_dv2_gates recomputes the pre-norm gates with the forward's skinny,
// wide (unclustered) or generic products, stopped before the LayerNorm pass,
// and gru_dv2_backward takes the LayerNorm and gate backward to the gate
// gradient dG (bf16), the direct term of dh and d_scale / d_bias. The three
// products from dG run outside (cuBLAS, bf16 operands, f32 sums). The
// backward's kernels live in namespace k1_bwd, so no trace takes them for
// the forward's k1:: kernels.
//
// Plain C interface, loaded with ctypes: each entry returns the CUDA error
// code of its launches (0 on success; negative codes are explained by
// gru_dv2_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <mma.h>
#include <mutex>
#include <stdint.h>
#include <stdio.h>

namespace k1 {

using bf16 = __nv_bfloat16;

constexpr int ROW_THREADS = 1024;  // block size of the LayerNorm/gate pass (one row a block)
constexpr float LN_EPS = 1e-3f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
// Sigmoid and tanh from one fast exponential and one fast reciprocal each:
// absolute error ~1e-7 (their values lie in [-1, 1]), far below K1's
// tolerances, at a fraction of the cost of expf, IEEE division and tanhf,
// which dominated the wide schedule's epilogue. exp overflowing to inf
// gives 0 through __fdividef, the right limit.
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.0f, 1.0f + __expf(-v)); }
__device__ __forceinline__ float tanh_fast(float v) { return 2.0f * sigmoid(2.0f * v) - 1.0f; }

// The late-reset gate math on one hidden unit, from normalised gates.
__device__ __forceinline__ float late_reset(float r, float u, float n, float hv) {
  const float update = sigmoid(u - 1.0f);
  return update * tanh_fast(sigmoid(r) * n) + (1.0f - update) * hv;
}

// ---------------------------------------------------------------------------
// LayerNorm + gate pass shared by every schedule but the clustered wide: one block per row sums `nsplit` partial gate rows (stride M*3H)
// into shared memory, takes mean and variance in two passes (as the
// reference) and writes h'.

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

template <typename HT>
__global__ void __launch_bounds__(ROW_THREADS)
ln_gate_kernel(const float* __restrict__ parts, int nsplit, const HT* __restrict__ h,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ out, int M, int H) {
  extern __shared__ float4 g4[];  // the row's 3H gates (float4 for 16-byte alignment)
  float* g = reinterpret_cast<float*>(g4);
  __shared__ float red[ROW_THREADS / 32];
  const int N = 3 * H;
  const size_t row = blockIdx.x;

  float s = 0.0f;
  if (N % 4 == 0) {  // rows start on 16 bytes: float4 loads, all splits in flight at once
    for (int j = threadIdx.x; j < N / 4; j += ROW_THREADS) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int p = 0; p < nsplit; ++p) {
        const float4 q = *reinterpret_cast<const float4*>(parts + ((size_t)p * M + row) * N + 4 * j);
        v.x += q.x;
        v.y += q.y;
        v.z += q.z;
        v.w += q.w;
      }
      *reinterpret_cast<float4*>(g + 4 * j) = v;
      s += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
      float v = 0.0f;
      for (int p = 0; p < nsplit; ++p) v += parts[((size_t)p * M + row) * N + j];
      g[j] = v;
      s += v;
    }
  }
  const float mean = block_sum(s, red) / N;  // also makes g visible to all
  float v = 0.0f;
  for (int j = threadIdx.x; j < N; j += ROW_THREADS) {
    const float d = g[j] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / N + LN_EPS);

  for (int j = threadIdx.x; j < H; j += ROW_THREADS) {
    const float r = (g[j] - mean) * rstd * scale[j] + bias[j];
    const float u = (g[H + j] - mean) * rstd * scale[H + j] + bias[H + j];
    const float n = (g[2 * H + j] - mean) * rstd * scale[2 * H + j] + bias[2 * H + j];
    out[row * H + j] = late_reset(r, u, n, to_f32(h[row * H + j]));
  }
}

// ---------------------------------------------------------------------------
// generic: WMMA bf16 GEMM, 64x64 output tile per 4-warp block, bounds-checked
// loads (any M, In, H), f32 gates to the workspace.

namespace generic {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int WARPS_N = 2;         // 2x2 warps, each owning a 32x32 sub-tile
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;       // padded leading dims (multiples of 8 for
constexpr int B_LD = BN + 8;       // 16-bit WMMA loads, of 4 for f32 stores,
constexpr int C_LD = BN + 4;       // every fragment start 32-byte aligned)

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

// The body of gates_kernel; K1's backward recompute (k1_bwd::generic_gates)
// runs it under its own name.
__device__ __forceinline__ void gates_tile(const bf16* __restrict__ x, const bf16* __restrict__ h,
                                           const bf16* __restrict__ w_ih,
                                           const bf16* __restrict__ w_hh,
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

__global__ void __launch_bounds__(THREADS)
gates_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
             const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh,
             float* __restrict__ gates, int M, int In, int H) {
  gates_tile(x, h, w_ih, w_hh, gates, M, In, H);
}

}  // namespace generic

// ---------------------------------------------------------------------------
// f32: SIMT FFMA GEMM in full float32, 64x64 tile per 256-thread block, each
// thread a 4x4 sub-tile; bounds-checked loads; f32 gates to the workspace.

namespace f32 {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ void fma_phase(const float* __restrict__ A,
                                          const float* __restrict__ B, int M,
                                          int K, int N, int m0, int n0,
                                          float (*As)[BM], float (*Bs)[BN],
                                          float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      As[k][r] = (m0 + r < M && k0 + k < K) ? A[(size_t)(m0 + r) * K + k0 + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int k = e / BN, c = e % BN;
      Bs[k][c] = (k0 + k < K && n0 + c < N) ? B[(size_t)(k0 + k) * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty * 4 + i];
        b[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
gates_kernel(const float* __restrict__ x, const float* __restrict__ h,
             const float* __restrict__ w_ih, const float* __restrict__ w_hh,
             float* __restrict__ gates, int M, int In, int H) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int N = 3 * H;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  fma_phase(x, w_ih, M, In, N, m0, n0, As, Bs, acc);
  fma_phase(h, w_hh, M, H, N, m0, n0, As, Bs, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N) gates[(size_t)r * N + c] = acc[i][j];
    }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// skinny: split-N x split-K weight streaming for a few rows (M <= 64).
//
// Block (bx, by) computes the partial gates of gate columns [64bx, 64bx+64)
// over rows [by*kc, by*kc+kc) of K = [x | h] . [w_ih; w_hh] (the K walk
// crosses from x/w_ih into h/w_hh at k = In) for all M rows. 4 warps, each
// 16 of the 64 columns. Shared memory holds the activations of the block's K
// range (MT*16 rows x kc, zero-filled past M and K) and a 16-stage ring of
// 32 x 64 weight tiles; 16-byte chunks are XOR-swizzled by row so that
// ldmatrix reads them without bank conflicts.

namespace skinny {

constexpr int BN = 64;        // gate columns per block (128 bytes of a weight row)
constexpr int BK = 32;        // weight rows per stage (4 KB)
constexpr int STAGES = 16;    // a whole 512-row slab in flight at once
constexpr int THREADS = 128;
constexpr int STAGE_BYTES = BK * BN * 2;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block: activations, then the weight ring.
__host__ __device__ constexpr int smem_bytes(int mt, int kc) {
  return mt * 16 * kc * 2 + STAGES * STAGE_BYTES;
}

// The body of gates_kernel; K1's backward recompute (k1_bwd::skinny_gates)
// runs it under its own name.
template <int MT>
__device__ __forceinline__ void gates_tile(const bf16* __restrict__ x, const bf16* __restrict__ h,
                                           const bf16* __restrict__ w_ih,
                                           const bf16* __restrict__ w_hh,
                                           float* __restrict__ parts, int M, int In, int H,
                                           int kc) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int N = 3 * H, K = In + H;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t a_smem = smem_u32(smem);
  const uint32_t b_smem = a_smem + MT * 16 * kc * 2;
  const int a_chunks = kc / 8;  // 16-byte chunks in one activation row

  // Activations [x | h] of this K range; chunk ch of row r sits at ch ^ (r % 8).
  for (int c = tid; c < MT * 16 * a_chunks; c += THREADS) {
    const int r = c / a_chunks, ch = c % a_chunks;
    const int k = k_begin + ch * 8;
    const bool ok = r < M && k < k_end;
    const bf16* src = !ok ? x : (k < In ? x + (size_t)r * In + k : h + (size_t)r * H + (k - In));
    cp_async16(a_smem + r * kc * 2 + ((ch ^ (r & 7)) * 16), src, ok);
  }
  auto load_w = [&](int st) {
    const uint32_t dst = b_smem + (st % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < STAGE_BYTES / 16 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / 8, ch = c % 8;
      const int k = k_begin + st * BK + r;
      const bool ok = k < k_end;
      const bf16* src = !ok ? w_ih
                            : (k < In ? w_ih + (size_t)k * N + n0 + ch * 8
                                      : w_hh + (size_t)(k - In) * N + n0 + ch * 8);
      cp_async16(dst + r * 128 + ((ch ^ (r & 7)) * 16), src, ok);
    }
  };
  // One commit group per stage; the first also carries the activations.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_stages) load_w(st);
    cp_async_commit();
  }

  float acc[MT][2][4] = {};
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<STAGES - 2>();  // stage st has landed
    __syncthreads();              // ... for every thread; slot (st-1) % STAGES is free
    if (st + STAGES - 1 < n_stages) load_w(st + STAGES - 1);
    cp_async_commit();
    const uint32_t ws = b_smem + (st % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // B fragments of this warp's 16 columns (two n8 tiles) from the
      // (k, n) row-major tile: ldmatrix.trans gives the K-pairs mma wants.
      uint32_t b[4];
      {
        const int q = lane / 8;
        const int k = kk + (q & 1) * 8 + lane % 8;
        const int ch = warp * 2 + (q >> 1);
        ldmatrix_x4_trans(ws + k * 128 + ((ch ^ (k & 7)) * 16), b);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        const int r = mt * 16 + lane % 16;
        const int ch = (st * BK + kk) / 8 + lane / 16;
        ldmatrix_x4(a_smem + r * kc * 2 + ((ch ^ (r & 7)) * 16), a);
        mma_16816(acc[mt][0], a, b[0], b[1]);
        mma_16816(acc[mt][1], a, b[2], b[3]);
      }
    }
  }

  float* dst = parts + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + (lane % 4) * 2;
      const int r0 = mt * 16 + lane / 4;
      if (r0 < M)
        *reinterpret_cast<float2*>(dst + (size_t)r0 * N + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < M)
        *reinterpret_cast<float2*>(dst + (size_t)(r0 + 8) * N + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
gates_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
             const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh,
             float* __restrict__ parts, int M, int In, int H, int kc) {
  gates_tile<MT>(x, h, w_ih, w_hh, parts, M, In, H, kc);
}

}  // namespace skinny

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores, shared by skinny_f32 and wide_f32. Each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi), both rounded
// to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds; v - hi
// is exact in f32. Then a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two
// small terms first, into f32 accumulators with mma.sync m16n8k8. What is
// dropped (a_lo.b_lo and the rounding of lo) is ~2^-22 of each product,
// near f32's 2^-24. The tensor cores' own sums lose low bits as a chain of
// products grows, so wide_f32 adds each 32-deep slice into its totals with
// IEEE f32 adds (an order of magnitude less error at M=1536 than one chain
// over all of K, for a few per cent of its time); skinny_f32's chains end
// at kc <= 256 rows anyway.
//
// Fragments of m16n8k8.tf32 (g = lane / 4, t = lane % 4): A (16x8, row):
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8x8, col): b0
// (k=t, n=g), b1 (k=t+4, n=g); C (16x8): c0, c1 (g, 2t..2t+1), c2, c3
// (g+8, 2t..2t+1). ldmatrix.x4 over f32 rows (one 16-byte matrix row = 4
// floats) hands out exactly the A fragment. B comes from an MN-major tile
// (the weights' own layout) by scalar loads, each tile row padded by 8
// floats so that the 32 lanes' (k=t, n=g) fall in 32 distinct banks.

namespace tf32x3 {

// cvt.rna.tf32.f32's rounding as two integer operations on the bit pattern
// (half of the 13 dropped bits' range added to the magnitude, then cleared;
// a carry moves into the exponent), which issue faster than the cvt. Finite
// values round as cvt.rna does.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// acc[m][n] += a[m].b[n] in 3xTF32 over MT x NT tiles of one 8-deep k step:
// a pass of a_lo.b_hi over all tiles, then a_hi.b_lo, then a_hi.b_hi, the
// small terms first. Consecutive mma.sync go to different accumulators.
template <int MT, int NT>
__device__ __forceinline__ void mma_3x(float (&acc)[MT][NT][4], const uint32_t (&a_hi)[MT][4],
                                       const uint32_t (&a_lo)[MT][4],
                                       const uint32_t (&b_hi)[NT][2],
                                       const uint32_t (&b_lo)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_1688(acc[m][n], a_lo[m], b_hi[n][0], b_hi[n][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_1688(acc[m][n], a_hi[m], b_lo[n][0], b_lo[n][1]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_1688(acc[m][n], a_hi[m], b_hi[n][0], b_hi[n][1]);
}
// The A fragment of the 16x8 tile at (row0, k0) of a row-major f32 tile in
// shared memory (`ld` floats a row, a multiple of 4 that is 4 mod 32, so the
// eight 16-byte rows of each ldmatrix phase miss no bank), split.
__device__ __forceinline__ void load_a(uint32_t tile, int ld, int row0, int k0, int lane,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int q = lane / 8;
  const int r = row0 + (q & 1) * 8 + lane % 8;
  uint32_t a[4];
  skinny::ldmatrix_x4(tile + (r * ld + k0 + (q >> 1) * 4) * 4, a);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), hi[i], lo[i]);
}
// The B fragment of the 8x8 tile at (k0, col0) of an MN-major f32 tile in
// shared memory (`ld` floats a row, 8 mod 32), split.
__device__ __forceinline__ void load_b(const float* tile, int ld, int k0, int col0, int lane,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = tile + (k0 + lane % 4) * ld + col0 + lane / 4;
  split(p[0], hi[0], lo[0]);
  split(p[4 * ld], hi[1], lo[1]);
}
// One 16-byte chunk of [x | h] at (row, k) or of [w_ih; w_hh] at (k, n):
// the K walk crosses from x / w_ih into h / w_hh at k = In, and In % 4 == 0
// keeps every chunk on one side.
__device__ __forceinline__ const float* act_chunk(const float* x, const float* h, int In, int H,
                                                  int row, int k) {
  return k < In ? x + (size_t)row * In + k : h + (size_t)row * H + (k - In);
}
__device__ __forceinline__ const float* weight_chunk(const float* w_ih, const float* w_hh, int In,
                                                     int N, int k, int n) {
  return k < In ? w_ih + (size_t)k * N + n : w_hh + (size_t)(k - In) * N + n;
}

}  // namespace tf32x3

// ---------------------------------------------------------------------------
// skinny_f32: skinny's split-N x split-K weight streaming in float32 with
// 3xTF32 products (M <= 64, In % 4 == 0, H % 4 == 0).
//
// Block (bx, by): partial gates of columns [64bx, 64bx+64) over rows
// [by*kc, by*kc+kc) of [w_ih; w_hh] (kc <= 256, a multiple of 32) for all M
// rows; 4 warps, each 16 of the 64 columns. The activations of the block's
// K range (MT*16 rows, padded to kc+4 floats) sit in shared memory whole;
// the weights stream through a 4-stage cp.async ring of 32 x 64 f32 tiles
// (8 KB each, rows padded to 72 floats). Columns past 3H and rows past K
// are zero-filled. At the flagship shape 48 x 8 = 384 blocks of 70 KB,
// three to an SM, all resident at once: 24.9 MB of weights with ~9 MB in
// flight.

namespace skinny_f32 {

constexpr int BN = 64;       // gate columns per block
constexpr int BK = 32;       // weight rows per stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int MAX_KC = 256;  // weight rows per block
constexpr int B_LD = BN + 8;
constexpr int STAGE_FLOATS = BK * B_LD;

__host__ __device__ constexpr int a_ld(int kc) { return kc + 4; }
__host__ __device__ constexpr int smem_bytes(int mt, int kc) {
  return (mt * 16 * a_ld(kc) + STAGES * STAGE_FLOATS) * 4;
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
gates_kernel(const float* __restrict__ x, const float* __restrict__ h,
             const float* __restrict__ w_ih, const float* __restrict__ w_hh,
             float* __restrict__ parts, int M, int In, int H, int kc) {
  using skinny::cp_async16;
  extern __shared__ __align__(128) float smem_sf[];
  const int N = 3 * H, K = In + H;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * kc;
  const int k_end = min(K, k_begin + kc);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lda = a_ld(kc);
  const float* b_s = smem_sf + MT * 16 * lda;
  const uint32_t a_smem = smem_u32(smem_sf);
  const uint32_t b_smem = smem_u32(b_s);

  // Activations [x | h] of this K range, zero past M and k_end.
  const int a_chunks = kc / 4;
  for (int c = tid; c < MT * 16 * a_chunks; c += THREADS) {
    const int r = c / a_chunks, kl = (c % a_chunks) * 4;
    const int k = k_begin + kl;
    const bool ok = r < M && k < k_end;
    cp_async16(a_smem + (r * lda + kl) * 4, ok ? tf32x3::act_chunk(x, h, In, H, r, k) : x, ok);
  }
  auto load_w = [&](int st) {
    const uint32_t dst = b_smem + (st % STAGES) * STAGE_FLOATS * 4;
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 4), nl = (c % (BN / 4)) * 4;
      const int k = k_begin + st * BK + r, n = n0 + nl;
      const bool ok = k < k_end && n < N;
      cp_async16(dst + (r * B_LD + nl) * 4,
                 ok ? tf32x3::weight_chunk(w_ih, w_hh, In, N, k, n) : w_ih, ok);
    }
  };
  // One commit group per stage; the first also carries the activations.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_stages) load_w(st);
    skinny::cp_async_commit();
  }

  float acc[MT][2][4] = {};
  for (int st = 0; st < n_stages; ++st) {
    skinny::cp_async_wait<STAGES - 2>();  // stage st has landed
    __syncthreads();                      // ... for every thread; slot (st-1) % STAGES is free
    if (st + STAGES - 1 < n_stages) load_w(st + STAGES - 1);
    skinny::cp_async_commit();
    const float* ws = b_s + (st % STAGES) * STAGE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        tf32x3::load_b(ws, B_LD, kk, warp * 16 + nt * 8, lane, b_hi[nt], b_lo[nt]);
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf32x3::load_a(a_smem, lda, mt * 16, st * BK + kk, lane, a_hi[mt], a_lo[mt]);
      tf32x3::mma_3x(acc, a_hi, a_lo, b_hi, b_lo);
    }
  }

  float* dst = parts + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + (lane % 4) * 2;
      const int r0 = mt * 16 + lane / 4;
      if (col >= N) continue;
      if (r0 < M)
        *reinterpret_cast<float2*>(dst + (size_t)r0 * N + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < M)
        *reinterpret_cast<float2*>(dst + (size_t)(r0 + 8) * N + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

}  // namespace skinny_f32

// ---------------------------------------------------------------------------
// wide_f32: a tiled float32 GEMM with 3xTF32 products for many rows (M > 64,
// In % 4 == 0, H % 4 == 0), then ln_gate_kernel.
//
// Block (bx, by): gates [BM*by, BM*by+BM) x [96bx, 96bx+96) over all of
// K = In + H. 8 warps in 2 x 4, each BM/2 rows x 24 columns (MT x 3 m16n8
// tiles). A 4-stage cp.async ring of 32-deep slices: the BM x 32 activation
// tile (rows padded to 36 floats, read by ldmatrix) and the 32 x 96 weight
// tile in its own MN-major layout (rows padded to 104 floats, read by scalar
// loads). Each slice's products start fresh accumulators on the tensor cores
// and are then added into the block's totals in f32. BM is 128, or 64 when
// 128-row tiles would give the card fewer than two waves of blocks (M=768:
// 192 tiles of 128 rows on 132 SMs, 384 of 64). 96 columns make the
// flagship grid 32 x 12 = 384 blocks of 128 rows, 2.9 waves of one block an
// SM (128 columns would make 2.2, with 27% of the last wave idle).

namespace wide_f32 {

constexpr int BN = 96;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int WARPS_N = 4;   // warps 2 (rows) x 4 (columns)
constexpr int NT = 3;        // n8 tiles of a warp: 24 columns
constexpr int A_LD = BK + 4;
constexpr int B_LD = BN + 8;

// MT m16 tiles of a warp: BM = 32 * MT rows a block.
__host__ __device__ constexpr int stage_floats(int mt) { return 32 * mt * A_LD + BK * B_LD; }
__host__ __device__ constexpr int smem_bytes(int mt) { return STAGES * stage_floats(mt) * 4; }

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
gates_kernel(const float* __restrict__ x, const float* __restrict__ h,
             const float* __restrict__ w_ih, const float* __restrict__ w_hh,
             float* __restrict__ gates, int M, int In, int H) {
  using skinny::cp_async16;
  constexpr int BM = 32 * MT;
  constexpr int STAGE_FLOATS = stage_floats(MT);
  extern __shared__ __align__(128) float smem_wf[];
  const int N = 3 * H, K = In + H;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const uint32_t base = smem_u32(smem_wf);

  auto load = [&](int kt) {
    const uint32_t sa = base + (kt % STAGES) * STAGE_FLOATS * 4;
    const uint32_t sb = sa + BM * A_LD * 4;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 4), kl = (c % (BK / 4)) * 4;
      const int row = m0 + r, k = k0 + kl;
      const bool ok = row < M && k < K;
      cp_async16(sa + (r * A_LD + kl) * 4, ok ? tf32x3::act_chunk(x, h, In, H, row, k) : x, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 4), nl = (c % (BN / 4)) * 4;
      const int k = k0 + r, n = n0 + nl;
      const bool ok = k < K && n < N;
      cp_async16(sb + (r * B_LD + nl) * 4,
                 ok ? tf32x3::weight_chunk(w_ih, w_hh, In, N, k, n) : w_ih, ok);
    }
  };
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < nk) load(kt);
    skinny::cp_async_commit();
  }

  float acc[MT][NT][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    skinny::cp_async_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();                      // ... for every thread; slot (kt-1) % STAGES is free
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    skinny::cp_async_commit();
    const uint32_t sa = base + (kt % STAGES) * STAGE_FLOATS * 4;
    const float* bs = smem_wf + (kt % STAGES) * STAGE_FLOATS + BM * A_LD;
    float part[MT][NT][4] = {};  // this slice's sums on the tensor cores
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        tf32x3::load_b(bs, B_LD, kk, wn * NT * 8 + nt * 8, lane, b_hi[nt], b_lo[nt]);
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tf32x3::load_a(sa, A_LD, wm * MT * 16 + mt * 16, kk, lane, a_hi[mt], a_lo[mt]);
      tf32x3::mma_3x(part, a_hi, a_lo, b_hi, b_lo);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * NT * 8 + nt * 8 + (lane % 4) * 2;
      const int r0 = m0 + wm * MT * 16 + mt * 16 + lane / 4;
      if (col >= N) continue;
      if (r0 < M)
        *reinterpret_cast<float2*>(gates + (size_t)r0 * N + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < M)
        *reinterpret_cast<float2*>(gates + (size_t)(r0 + 8) * N + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

}  // namespace wide_f32

// ---------------------------------------------------------------------------
// wide: warp-specialised wgmma + TMA for many rows (M > 64, H % 128 == 0).
//
// Block (j, i): rows [128i, 128i+128), hidden units [128j, 128j+128) of all
// three gates. Threads 0-255 are two consumer warpgroups (rows 0-63 and
// 64-127 of the tile), threads 256-383 the producer warpgroup, of which one
// thread issues the TMA loads. A stage holds a 128x32 tile of x or h
// (K-major, 64-byte swizzle, 8 KB) and six 32x64 tiles of w_ih or w_hh
// (3 gates x 2 column halves, MN-major, 128-byte swizzle, 4 KB each); five
// stages, so that three load while the products of two run. The other
// producer warps stage the epilogue's scale, bias and h tile meanwhile.

namespace wide {

constexpr int BM = 128;
constexpr int HB = 128;
constexpr int BK = 32;
constexpr int STAGES = 5;
constexpr int THREADS = 384;
constexpr int MAX_CLUSTER = 8;
constexpr uint32_t A_BYTES = BM * BK * 2;          // 8 KB
constexpr uint32_t B_BOX = BK * 64 * 2;            // 4 KB: 32 K rows x 64 columns
constexpr uint32_t STAGE_BYTES = A_BYTES + 6 * B_BOX;  // 32 KB
constexpr int H_LD = HB + 8;  // h tile row, padded: the epilogue's reads miss no bank
constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + 2 * BM * 4 +
                        2 * 3 * HB * 4 + BM * H_LD * 2;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// A float at the same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// wgmma shared-memory descriptors.
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFF) >> 4);
}
// K-major (A: x/h tiles) in the 64-byte swizzle (layout type 2): rows of 64
// bytes, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_field(addr) | (desc_field(16) << 16) | (desc_field(512) << 32) | (2ull << 62);
}
// MN-major (B: weight tiles) in the 128-byte swizzle (layout type 1):
// 64-column blocks `mn_stride` bytes apart
// (leading byte offset), 8-row K groups 1024 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t mn_stride) {
  return desc_field(addr) | (desc_field(mn_stride) << 16) | (desc_field(1024) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a wgmma.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64x128 f32) += A (64x16, K-major) . B (16x128, MN-major), bf16 operands.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// kCluster: the H/HB blocks of a row tile form one cluster and the epilogue
// writes h'; otherwise it writes the f32 gates for ln_gate_kernel.
// The body of gates_kernel, on the kernel's own parameters (the tensor maps
// stay in parameter space); K1's backward recompute (k1_bwd::wide_gates) runs
// the unclustered one under its own name.
template <bool kCluster>
__device__ __forceinline__ void gates_tile(const CUtensorMap& tm_x, const CUtensorMap& tm_h,
                                           const CUtensorMap& tm_wih, const CUtensorMap& tm_whh,
                                           const bf16* __restrict__ h,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, float* __restrict__ gates,
                                           int M, int In, int H) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle wants 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* st_mean = reinterpret_cast<float*>(empty + STAGES);
  float* st_m2 = st_mean + BM;
  float* s_scale = st_m2 + BM;     // this block's 3*HB LayerNorm scales, gate-major
  float* s_bias = s_scale + 3 * HB;
  bf16* s_h = reinterpret_cast<bf16*>(s_bias + 3 * HB);  // h[m0:m0+BM, j*HB:(j+1)*HB]

  const int tid = threadIdx.x;
  const int j = blockIdx.x;  // hidden slab; also the rank in the cluster
  const int m0 = blockIdx.y * BM;
  const int nk_x = (In + BK - 1) / BK;
  const int nk = nk_x + H / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // Producer warpgroup.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const uint32_t sa = base + s * STAGE_BYTES;
        const bool first = kt < nk_x;
        const int k0 = (first ? kt : kt - nk_x) * BK;
        tma_load_2d(sa, first ? &tm_x : &tm_h, &full[s], k0, m0);
        const CUtensorMap* tw = first ? &tm_wih : &tm_whh;
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load_2d(sa + A_BYTES + (g * 2 + half) * B_BOX, tw, &full[s],
                        g * H + j * HB + half * 64, k0);
      }
    }
    if (kCluster) {
      // The rest of the warpgroup stages the block's scale, bias and h tile
      // for the epilogue while the products run (the epilogue's own global
      // loads of h would wait in series); the first cluster barrier
      // publishes them.
      for (int c = tid - 288; c >= 0 && c < 3 * HB; c += THREADS - 288) {
        const int col = (c / HB) * H + j * HB + c % HB;
        s_scale[c] = scale[col];
        s_bias[c] = bias[col];
      }
      for (int c = tid - 288; c >= 0 && c < BM * HB / 8; c += THREADS - 288) {
        const int r = c / (HB / 8), col = (c % (HB / 8)) * 8;
        if (m0 + r < M)
          *reinterpret_cast<uint4*>(s_h + r * H_LD + col) =
              *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * H + j * HB + col);
      }
      // The consumers' two cluster barriers.
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
  } else {
    // Consumer warpgroups.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[3][64];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[g][i] = 0.0f;
      fence_operands(acc[g]);
    }

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t sa = base + s * STAGE_BYTES + wg * 64 * BK * 2;
      const uint32_t sb = base + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_k_major(sa + kk * 32);
#pragma unroll
        for (int g = 0; g < 3; ++g)
          wgmma_m64n128k16(acc[g], da, desc_mn_major(sb + g * 2 * B_BOX + kk * 16 * 128, B_BOX));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free its slot
      if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < 3; ++g) fence_operands(acc[g]);

    // Accumulator layout of m64nNk16: register i of this thread holds row
    // warp*16 + lane/4 + 8*((i/2)%2), column (i/4)*8 + (lane%4)*2 + i%2.
    const int rl = wg * 64 + warp * 16 + lane / 4;  // local rows rl and rl + 8
    const int c_lane = (lane % 4) * 2;

    if constexpr (kCluster) {
      // Per-row (mean, M2) over this block's 3*HB columns, two passes.
      float mean[2], rstd[2];
      {
        float s[2] = {0.0f, 0.0f};
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int i = 0; i < 64; ++i) s[(i / 2) % 2] += acc[g][i];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          s[rh] += __shfl_xor_sync(0xffffffffu, s[rh], 1);
          s[rh] += __shfl_xor_sync(0xffffffffu, s[rh], 2);
          mean[rh] = s[rh] * (1.0f / (3 * HB));
        }
        float q[2] = {0.0f, 0.0f};
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const float d = acc[g][i] - mean[(i / 2) % 2];
            q[(i / 2) % 2] += d * d;
          }
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          q[rh] += __shfl_xor_sync(0xffffffffu, q[rh], 1);
          q[rh] += __shfl_xor_sync(0xffffffffu, q[rh], 2);
        }
        if (lane % 4 == 0) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            st_mean[rl + 8 * rh] = mean[rh];
            st_m2[rl + 8 * rh] = q[rh];
          }
        }
      }
      cluster_arrive();
      cluster_wait();  // every block's statistics are in its shared memory
      // Chan's combination over the cluster's blocks, equal counts of 3*HB.
      // All remote loads are issued before any is used.
      const int cs = H / HB;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = rl + 8 * rh;
        float bm[MAX_CLUSTER], bq[MAX_CLUSTER];
#pragma unroll
        for (int b = 0; b < MAX_CLUSTER; ++b) {
          bm[b] = b < cs ? ld_cluster(&st_mean[r], b) : 0.0f;
          bq[b] = b < cs ? ld_cluster(&st_m2[r], b) : 0.0f;
        }
        float msum = 0.0f;
#pragma unroll
        for (int b = 0; b < MAX_CLUSTER; ++b) msum += bm[b];
        const float m = msum / cs;
        float m2 = 0.0f;
#pragma unroll
        for (int b = 0; b < MAX_CLUSTER; ++b) {
          const float d = bm[b] - m;
          m2 += b < cs ? bq[b] + (float)(3 * HB) * d * d : 0.0f;
        }
        mean[rh] = m;
        rstd[rh] = rsqrtf(m2 / (float)(3 * H) + LN_EPS);
      }
      cluster_arrive();  // done reading the other blocks' shared memory

#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int rh = (i / 2) % 2;
        const int row = m0 + rl + 8 * rh;
        const int c = (i / 4) * 8 + c_lane;
        const int u = j * HB + c;  // hidden unit
        if (row < M) {
          const float2 sr = *reinterpret_cast<const float2*>(s_scale + c);
          const float2 su = *reinterpret_cast<const float2*>(s_scale + HB + c);
          const float2 sn = *reinterpret_cast<const float2*>(s_scale + 2 * HB + c);
          const float2 br = *reinterpret_cast<const float2*>(s_bias + c);
          const float2 bu = *reinterpret_cast<const float2*>(s_bias + HB + c);
          const float2 bn = *reinterpret_cast<const float2*>(s_bias + 2 * HB + c);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(s_h + (rl + 8 * rh) * H_LD + c);
          const float mu = mean[rh], rs = rstd[rh];
          float2 o;
          o.x = late_reset((acc[0][i] - mu) * rs * sr.x + br.x, (acc[1][i] - mu) * rs * su.x + bu.x,
                           (acc[2][i] - mu) * rs * sn.x + bn.x, __low2float(hv));
          o.y = late_reset((acc[0][i + 1] - mu) * rs * sr.y + br.y,
                           (acc[1][i + 1] - mu) * rs * su.y + bu.y,
                           (acc[2][i + 1] - mu) * rs * sn.y + bn.y, __high2float(hv));
          *reinterpret_cast<float2*>(out + (size_t)row * H + u) = o;
        }
      }
      cluster_wait();  // no block leaves while another may still read its statistics
    } else {
      const int N = 3 * H;
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int row = m0 + rl + 8 * ((i / 2) % 2);
          const int col = g * H + j * HB + (i / 4) * 8 + c_lane;
          if (row < M)
            *reinterpret_cast<float2*>(gates + (size_t)row * N + col) =
                make_float2(acc[g][i], acc[g][i + 1]);
        }
    }
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(THREADS, 1)
gates_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_h,
             const __grid_constant__ CUtensorMap tm_wih, const __grid_constant__ CUtensorMap tm_whh,
             const bf16* __restrict__ h, const float* __restrict__ scale,
             const float* __restrict__ bias, float* __restrict__ out,
             float* __restrict__ gates, int M, int In, int H) {
  gates_tile<kCluster>(tm_x, tm_h, tm_wih, tm_whh, h, scale, bias, out, gates, M, In, H);
}

}  // namespace wide

}  // namespace k1

// ---------------------------------------------------------------------------
// K1's backward (GRUDv2Function.backward's bf16 pass), in namespace k1_bwd:
// its kernels' names never carry the forward's k1:: (the traces count K1's
// forward kernels by it). The recompute runs the forward's gate products
// under names of its own; the rest is the LayerNorm and gate backward.
//
// The backward of the LayerNorm and the gates: the middle of the bf16 pass of
// GRUDv2Function.backward (ops/gru_dv2.py::k1_backward). The pre-norm gates G
// come from the forward's own schedule stopped before its LayerNorm pass
// (gru_dv2_gates: skinny's nsplit partial sums, wide's and generic's
// workspace), so the backward normalises what the forward normalised. Per
// row, with go = dL/dh' (f32):
//
//   gn = (G - mean) * rstd, y = gn * scale + bias, (r, u, n) = split(y)
//   reset = sigmoid(r), update = sigmoid(u - 1), t = tanh(reset * n)
//   dy_u = go (t - h) update (1 - update)
//   dy_n = go update (1 - t^2) reset
//   dy_r = go update (1 - t^2) n reset (1 - reset)
//   dgn = dy * scale
//   dG = rstd (dgn - mean(dgn) - gn mean(dgn gn))   -> bf16, the operand of the three products
//   dh' direct term (1 - update) go                  -> f32 (dh = this + dG . w_hh^T)
//   d_scale += dy gn, d_bias += dy                   -> f32, the block's part
//
// One block of 1024 threads per `rows` consecutive rows, taken one after
// another: one row (each of the posterior's 16-64 rows has a block), or
// about M / 256 of the dream's 1024-1536 rows, so that the blocks' parts of
// d_scale and d_bias stay few (256 x 6H floats). Shared memory holds the
// row's gates (then its normalised gates), dgn, and the block's two sums:
// 4 x 3H floats (192 KB at H = 4096). col_sum_kernel then adds the parts
// column by column in block order: a fixed order and no atomics, so a step
// replayed from CUDA graphs repeats the eager one bit for bit.

namespace k1_bwd {

using namespace k1;

constexpr int THREADS = ROW_THREADS;

// The forward's gate products (stopped before its LayerNorm pass).
template <int MT>
__global__ void __launch_bounds__(skinny::THREADS)
skinny_gates(const bf16* __restrict__ x, const bf16* __restrict__ h,
             const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh,
             float* __restrict__ parts, int M, int In, int H, int kc) {
  skinny::gates_tile<MT>(x, h, w_ih, w_hh, parts, M, In, H, kc);
}

__global__ void __launch_bounds__(wide::THREADS, 1)
wide_gates(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_h,
           const __grid_constant__ CUtensorMap tm_wih, const __grid_constant__ CUtensorMap tm_whh,
           const bf16* __restrict__ h, const float* __restrict__ scale,
           const float* __restrict__ bias, float* __restrict__ out,
           float* __restrict__ gates, int M, int In, int H) {
  wide::gates_tile<false>(tm_x, tm_h, tm_wih, tm_whh, h, scale, bias, out, gates, M, In, H);
}

__global__ void __launch_bounds__(generic::THREADS)
generic_gates(const bf16* __restrict__ x, const bf16* __restrict__ h,
              const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh,
              float* __restrict__ gates, int M, int In, int H) {
  generic::gates_tile(x, h, w_ih, w_hh, gates, M, In, H);
}

__host__ __device__ constexpr size_t smem_bytes(int H, bool params) {
  return (size_t)(params ? 4 : 2) * 3 * H * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
ln_gate_backward(const float* __restrict__ parts, int nsplit, const bf16* __restrict__ h,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const float* __restrict__ grad_out, bf16* __restrict__ dG, float* __restrict__ dh,
                float* __restrict__ param_parts, int M, int H, int rows) {
  extern __shared__ float4 g4[];
  __shared__ float red[THREADS / 32];
  const int N = 3 * H;
  float* g = reinterpret_cast<float*>(g4);  // the row's gates, then its normalised gates
  float* dgn = g + N;
  float* acc_s = dgn + N;  // the block's sums of dy * gn and of dy (with param_parts only)
  float* acc_b = acc_s + N;
  const bool params = param_parts != nullptr;
  // A thread owns the same hidden units (and their three columns) in every
  // row: no other thread touches their acc_s / acc_b, which need no barrier.
  if (params)
    for (int j = threadIdx.x; j < H; j += THREADS)
#pragma unroll
      for (int q = 0; q < 3; ++q) acc_s[q * H + j] = acc_b[q * H + j] = 0.0f;
  const int r_begin = blockIdx.x * rows, r_end = min(M, r_begin + rows);
  for (int row = r_begin; row < r_end; ++row) {
    // The gates, summed over the partial rows as ln_gate_kernel sums them.
    float s = 0.0f;
    if (N % 4 == 0) {
      for (int j = threadIdx.x; j < N / 4; j += THREADS) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int p = 0; p < nsplit; ++p) {
          const float4 q =
              *reinterpret_cast<const float4*>(parts + ((size_t)p * M + row) * N + 4 * j);
          v.x += q.x;
          v.y += q.y;
          v.z += q.z;
          v.w += q.w;
        }
        *reinterpret_cast<float4*>(g + 4 * j) = v;
        s += (v.x + v.y) + (v.z + v.w);
      }
    } else {
      for (int j = threadIdx.x; j < N; j += THREADS) {
        float v = 0.0f;
        for (int p = 0; p < nsplit; ++p) v += parts[((size_t)p * M + row) * N + j];
        g[j] = v;
        s += v;
      }
    }
    const float mean = block_sum(s, red) / N;
    float var = 0.0f;
    for (int j = threadIdx.x; j < N; j += THREADS) {
      const float d = g[j] - mean;
      var += d * d;
    }
    const float rstd = rsqrtf(block_sum(var, red) / N + LN_EPS);

    float sum_d = 0.0f, sum_dg = 0.0f;
    for (int j = threadIdx.x; j < H; j += THREADS) {
      float gn[3], y[3], dy[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        gn[q] = (g[q * H + j] - mean) * rstd;
        y[q] = gn[q] * scale[q * H + j] + bias[q * H + j];
      }
      const float reset = sigmoid(y[0]), update = sigmoid(y[1] - 1.0f);
      const float t = tanh_fast(reset * y[2]);
      const size_t o = (size_t)row * H + j;
      const float go = grad_out[o];
      if (dh != nullptr) dh[o] = (1.0f - update) * go;
      const float dt = go * update * (1.0f - t * t);
      dy[0] = dt * y[2] * reset * (1.0f - reset);
      dy[1] = go * (t - to_f32(h[o])) * update * (1.0f - update);
      dy[2] = dt * reset;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = q * H + j;
        const float d = dy[q] * scale[c];
        g[c] = gn[q];
        dgn[c] = d;
        sum_d += d;
        sum_dg += d * gn[q];
        if (params) {
          acc_s[c] += dy[q] * gn[q];
          acc_b[c] += dy[q];
        }
      }
    }
    const float mean_d = block_sum(sum_d, red) / N;
    const float mean_dg = block_sum(sum_dg, red) / N;
    for (int j = threadIdx.x; j < H; j += THREADS)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = q * H + j;
        dG[(size_t)row * N + c] = __float2bfloat16(rstd * (dgn[c] - mean_d - g[c] * mean_dg));
      }
    __syncthreads();  // the next row refills g
  }
  if (params)
    for (int j = threadIdx.x; j < H; j += THREADS)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = q * H + j;
        param_parts[(size_t)blockIdx.x * 2 * N + c] = acc_s[c];
        param_parts[(size_t)blockIdx.x * 2 * N + N + c] = acc_b[c];
      }
}

// out[c] = sum over p < P of parts[p * n + c], p in order.
__global__ void col_sum(const float* __restrict__ parts, int P, int n,
                               float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.0f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) s += parts[(size_t)p * n + c];
  out[c] = s;
}

}  // namespace k1_bwd

namespace k1 {

// ---------------------------------------------------------------------------
// Host side.

// Schedules, in the order of ops/gru_dv2.py's SCHEDULES.
enum Schedule { kGeneric = 0, kSkinny = 1, kWide = 2, kF32 = 3, kSkinnyF32 = 4, kWideF32 = 5 };

// Error codes of this library beside CUDA's own (see gru_dv2_error_string).
constexpr int kErrNoEncoder = -1;      // cuTensorMapEncodeTiled not found in libcuda
constexpr int kErrBadPlan = -2;        // schedule and shape do not fit together
constexpr int kErrEncodeBase = -1000;  // -1000 - CUresult of cuTensorMapEncodeTiled

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// CUDA's tensor-map encoder, from the libcuda the process already runs on.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// 2-D map of a row-major bf16 (rows, cols) matrix with box (box_rows, box_cols);
// reads outside the matrix fill zeros.
int make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
             uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - (int)r;
}

// Allow `bytes` of dynamic shared memory for kernel `fn` on the current
// device. The attribute is set once per kernel, device and size, not on
// every launch: the train step is host-bound. Without it a block may hold
// 48 KB in all, its static shared memory included (ln_gate_kernel's 128
// bytes of partial sums beside 3H floats of gates: 48 KB of gates at
// H=4096 does not fit), so sizes within 1 KB of the limit take it too.
int allow_smem(const void* fn, int bytes) {
  if (bytes <= 47 * 1024) return 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  struct Seen {
    const void* fn;
    int dev, bytes;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev && seen[i].bytes >= bytes) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (n_seen < 64) seen[n_seen++] = Seen{fn, dev, bytes};
  return 0;
}

template <typename HT>
int launch_ln_gate(const float* parts, int nsplit, const HT* h, const float* scale,
                   const float* bias, float* out, int M, int H, cudaStream_t s) {
  const size_t smem = (size_t)3 * H * sizeof(float);
  const int err = allow_smem((const void*)ln_gate_kernel<HT>, (int)smem);
  if (err) return err;
  ln_gate_kernel<HT><<<M, ROW_THREADS, smem, s>>>(parts, nsplit, h, scale, bias, out, M, H);
  return (int)cudaGetLastError();
}

// skinny's partial gates alone (nsplit x M x 3H f32 in `parts`); `recompute`:
// the backward's kernel of the same products (k1_bwd::skinny_gates).
int launch_skinny_gates(const bf16* x, const bf16* h, const bf16* w_ih, const bf16* w_hh,
                        float* parts, int M, int In, int H, int nsplit, int kc, cudaStream_t s,
                        bool recompute = false) {
  const int K = In + H;
  if (M > 64 || In % 8 != 0 || H % 64 != 0 || kc % 64 != 0 || kc > 512 || nsplit < 1 ||
      (long)nsplit * kc < K || (long)(nsplit - 1) * kc >= K || parts == nullptr)
    return kErrBadPlan;
  const int mt = M <= 32 ? 2 : 4;
  const int smem = skinny::smem_bytes(mt, kc);
  auto kern = mt == 2 ? skinny::gates_kernel<2> : skinny::gates_kernel<4>;
  if (recompute) kern = mt == 2 ? k1_bwd::skinny_gates<2> : k1_bwd::skinny_gates<4>;
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  kern<<<dim3(3 * H / skinny::BN, nsplit), skinny::THREADS, smem, s>>>(x, h, w_ih, w_hh, parts, M,
                                                                       In, H, kc);
  return (int)cudaGetLastError();
}

int launch_skinny(const bf16* x, const bf16* h, const bf16* w_ih, const bf16* w_hh,
                  const float* scale, const float* bias, float* parts, float* out, int M, int In,
                  int H, int nsplit, int kc, cudaStream_t s) {
  const int err = launch_skinny_gates(x, h, w_ih, w_hh, parts, M, In, H, nsplit, kc, s);
  if (err) return err;
  return launch_ln_gate(parts, nsplit, h, scale, bias, out, M, H, s);
}

int launch_skinny_f32(const float* x, const float* h, const float* w_ih, const float* w_hh,
                      const float* scale, const float* bias, float* parts, float* out, int M,
                      int In, int H, int nsplit, int kc, cudaStream_t s) {
  using namespace skinny_f32;
  const int K = In + H;
  if (M > 64 || In % 4 != 0 || H % 4 != 0 || kc % BK != 0 || kc > MAX_KC || nsplit < 1 ||
      (long)nsplit * kc < K || (long)(nsplit - 1) * kc >= K || parts == nullptr)
    return kErrBadPlan;
  const int mt = (M + 15) / 16;
  const int smem = smem_bytes(mt, kc);
  auto kern = mt == 1 ? gates_kernel<1> : mt == 2 ? gates_kernel<2> : mt == 3 ? gates_kernel<3>
                                                                               : gates_kernel<4>;
  const int err = allow_smem((const void*)kern, smem);
  if (err) return err;
  kern<<<dim3((3 * H + BN - 1) / BN, nsplit), THREADS, smem, s>>>(x, h, w_ih, w_hh, parts, M, In,
                                                                  H, kc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_ln_gate(parts, nsplit, h, scale, bias, out, M, H, s);
}

// Streaming multiprocessors of the current device.
int sm_count(int* n) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

int launch_wide_f32(const float* x, const float* h, const float* w_ih, const float* w_hh,
                    const float* scale, const float* bias, float* gates, float* out, int M, int In,
                    int H, cudaStream_t s) {
  using namespace wide_f32;
  if (M <= 64 || In % 4 != 0 || H % 4 != 0 || gates == nullptr) return kErrBadPlan;
  int sms;
  int err = sm_count(&sms);
  if (err) return err;
  const int col_tiles = (3 * H + BN - 1) / BN;
  const int mt = (long)((M + 127) / 128) * col_tiles < 2L * sms ? 2 : 4;  // 64 or 128 rows
  auto kern = mt == 2 ? gates_kernel<2> : gates_kernel<4>;
  err = allow_smem((const void*)kern, smem_bytes(mt));
  if (err) return err;
  kern<<<dim3(col_tiles, (M + 32 * mt - 1) / (32 * mt)), THREADS, smem_bytes(mt), s>>>(
      x, h, w_ih, w_hh, gates, M, In, H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_ln_gate(gates, 1, h, scale, bias, out, M, H, s);
}

template <bool kCluster>
int launch_wide_kernel(const CUtensorMap (&maps)[4], const bf16* h, const float* scale,
                       const float* bias, float* out, float* gates, int M, int In, int H,
                       cudaStream_t s, bool recompute = false) {
  auto kern = wide::gates_kernel<kCluster>;
  if (recompute && !kCluster) kern = k1_bwd::wide_gates;
  const int err = allow_smem((const void*)kern, (int)wide::SMEM);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / wide::HB, (M + wide::BM - 1) / wide::BM);
  cfg.blockDim = dim3(wide::THREADS);
  cfg.dynamicSmemBytes = wide::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H / wide::HB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, maps[0], maps[1], maps[2], maps[3], h, scale, bias, out,
                         gates, M, In, H);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The TMA maps of wide's four operands.
int wide_maps(CUtensorMap (&maps)[4], const bf16* x, const bf16* h, const bf16* w_ih,
              const bf16* w_hh, int M, int In, int H) {
  if (M <= 64 || In % 8 != 0 || H % wide::HB != 0) return kErrBadPlan;
  const CUtensorMapSwizzle sw_a = CU_TENSOR_MAP_SWIZZLE_64B, sw_b = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = make_map(&maps[0], x, M, In, wide::BM, wide::BK, sw_a);
  if (!err) err = make_map(&maps[1], h, M, H, wide::BM, wide::BK, sw_a);
  if (!err) err = make_map(&maps[2], w_ih, In, 3 * H, wide::BK, 64, sw_b);
  if (!err) err = make_map(&maps[3], w_hh, H, 3 * H, wide::BK, 64, sw_b);
  return err;
}

// wide's gates alone (M x 3H f32 in `gates`), at any H: the unclustered
// kernel; `recompute`: the backward's kernel of it (k1_bwd::wide_gates).
int launch_wide_gates(const bf16* x, const bf16* h, const bf16* w_ih, const bf16* w_hh,
                      float* gates, int M, int In, int H, cudaStream_t s, bool recompute = false) {
  CUtensorMap maps[4];
  const int err = wide_maps(maps, x, h, w_ih, w_hh, M, In, H);
  if (err) return err;
  if (gates == nullptr) return kErrBadPlan;
  return launch_wide_kernel<false>(maps, h, nullptr, nullptr, nullptr, gates, M, In, H, s,
                                   recompute);
}

int launch_wide(const bf16* x, const bf16* h, const bf16* w_ih, const bf16* w_hh,
                const float* scale, const float* bias, float* gates, float* out, int M, int In,
                int H, cudaStream_t s) {
  if (H % wide::HB == 0 && H / wide::HB <= wide::MAX_CLUSTER) {
    CUtensorMap maps[4];
    const int err = wide_maps(maps, x, h, w_ih, w_hh, M, In, H);
    if (err) return err;
    return launch_wide_kernel<true>(maps, h, scale, bias, out, gates, M, In, H, s);
  }
  const int err = launch_wide_gates(x, h, w_ih, w_hh, gates, M, In, H, s);
  if (err) return err;
  return launch_ln_gate(gates, 1, h, scale, bias, out, M, H, s);
}

// generic's gates alone (M x 3H f32 in `gates`); `recompute`: the backward's
// kernel of it (k1_bwd::generic_gates).
int launch_generic_gates(const bf16* x, const bf16* h, const bf16* w_ih, const bf16* w_hh,
                         float* gates, int M, int In, int H, cudaStream_t s,
                         bool recompute = false) {
  if (gates == nullptr) return kErrBadPlan;
  const dim3 grid((3 * H + generic::BN - 1) / generic::BN, (M + generic::BM - 1) / generic::BM);
  auto kern = recompute ? k1_bwd::generic_gates : generic::gates_kernel;
  kern<<<grid, generic::THREADS, 0, s>>>(x, h, w_ih, w_hh, gates, M, In, H);
  return (int)cudaGetLastError();
}

// The LayerNorm/gate backward of `rows`-row blocks, then (with param_parts)
// the blocks' parts of d_scale and d_bias summed into dparams (2 x 3H).
int launch_backward(const float* parts, int nsplit, const bf16* h, const float* scale,
                    const float* bias, const float* grad_out, bf16* dG, float* dh,
                    float* param_parts, float* dparams, int M, int H, int rows, cudaStream_t s) {
  const bool params = param_parts != nullptr;
  if (rows < 1 || nsplit < 1 || parts == nullptr || dG == nullptr || params != (dparams != nullptr))
    return kErrBadPlan;
  const int blocks = (M + rows - 1) / rows;
  const size_t smem = k1_bwd::smem_bytes(H, params);
  const int err = allow_smem((const void*)k1_bwd::ln_gate_backward, (int)smem);
  if (err) return err;
  k1_bwd::ln_gate_backward<<<blocks, k1_bwd::THREADS, smem, s>>>(
      parts, nsplit, h, scale, bias, grad_out, dG, dh, param_parts, M, H, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !params) return (int)e;
  const int n = 6 * H;
  k1_bwd::col_sum<<<(n + 255) / 256, 256, 0, s>>>(param_parts, blocks, n, dparams);
  return (int)cudaGetLastError();
}

}  // namespace k1

// One K1 step on `stream`. `work` is the f32 workspace the schedule needs
// (see plan() in ops/gru_dv2.py); nsplit and kc are the K split of skinny
// and skinny_f32. Returns 0 or an error code for gru_dv2_error_string.
extern "C" int gru_dv2_forward(int schedule, const void* x, const void* h, const void* w_ih,
                               const void* w_hh, const void* scale, const void* bias, void* work,
                               void* out, int M, int In, int H, int nsplit, int kc,
                               void* stream) {
  using namespace k1;
  if (M <= 0 || In <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(work);
  const bf16 *xb = static_cast<const bf16*>(x), *hb = static_cast<const bf16*>(h);
  const bf16 *wib = static_cast<const bf16*>(w_ih), *whb = static_cast<const bf16*>(w_hh);
  switch (schedule) {
    case kSkinny:
      return launch_skinny(xb, hb, wib, whb, sc, bi, w, o, M, In, H, nsplit, kc, s);
    case kWide:
      return launch_wide(xb, hb, wib, whb, sc, bi, w, o, M, In, H, s);
    case kGeneric: {
      const int err = launch_generic_gates(xb, hb, wib, whb, w, M, In, H, s);
      if (err) return err;
      return launch_ln_gate(w, 1, hb, sc, bi, o, M, H, s);
    }
    case kF32: {
      const float *xf = static_cast<const float*>(x), *hf = static_cast<const float*>(h);
      const dim3 grid((3 * H + f32::BN - 1) / f32::BN, (M + f32::BM - 1) / f32::BM);
      f32::gates_kernel<<<grid, f32::THREADS, 0, s>>>(xf, hf, static_cast<const float*>(w_ih),
                                                      static_cast<const float*>(w_hh), w, M, In,
                                                      H);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      return launch_ln_gate(w, 1, hf, sc, bi, o, M, H, s);
    }
    case kSkinnyF32:
      return launch_skinny_f32(static_cast<const float*>(x), static_cast<const float*>(h),
                               static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
                               sc, bi, w, o, M, In, H, nsplit, kc, s);
    case kWideF32:
      return launch_wide_f32(static_cast<const float*>(x), static_cast<const float*>(h),
                             static_cast<const float*>(w_ih), static_cast<const float*>(w_hh), sc,
                             bi, w, o, M, In, H, s);
    default:
      return kErrBadPlan;
  }
}

// The pre-norm gates x . w_ih + h . w_hh of a bf16 schedule (skinny, wide or
// generic), stopped before its LayerNorm pass: `work` gets skinny's nsplit
// partial sums (nsplit x M x 3H f32) or, for wide and generic, M x 3H f32,
// the same sums the forward normalises.
extern "C" int gru_dv2_gates(int schedule, const void* x, const void* h, const void* w_ih,
                             const void* w_hh, void* work, int M, int In, int H, int nsplit,
                             int kc, void* stream) {
  using namespace k1;
  if (M <= 0 || In <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *hb = static_cast<const bf16*>(h);
  const bf16 *wib = static_cast<const bf16*>(w_ih), *whb = static_cast<const bf16*>(w_hh);
  float* w = static_cast<float*>(work);
  switch (schedule) {
    case kSkinny:
      return launch_skinny_gates(xb, hb, wib, whb, w, M, In, H, nsplit, kc, s, true);
    case kWide:
      return launch_wide_gates(xb, hb, wib, whb, w, M, In, H, s, true);
    case kGeneric:
      return launch_generic_gates(xb, hb, wib, whb, w, M, In, H, s, true);
    default:
      return kErrBadPlan;
  }
}

// The LayerNorm and gate backward of one K1 step on `stream`, from the gates
// of gru_dv2_gates (`parts`, nsplit partial sums), h (bf16), scale, bias and
// dL/dh' (f32, M x H): dG (M x 3H bf16), the direct term of dh (M x H f32;
// skipped when dh is null) and, when param_parts (blocks x 2 x 3H f32, blocks
// = ceil(M / rows)) is given, d_scale and d_bias in dparams (2 x 3H f32).
extern "C" int gru_dv2_backward(const void* parts, int nsplit, const void* h, const void* scale,
                                const void* bias, const void* grad_out, void* dG, void* dh,
                                void* param_parts, void* dparams, int M, int H, int rows,
                                void* stream) {
  using namespace k1;
  if (M <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return launch_backward(static_cast<const float*>(parts), nsplit, static_cast<const bf16*>(h),
                         static_cast<const float*>(scale), static_cast<const float*>(bias),
                         static_cast<const float*>(grad_out), static_cast<bf16*>(dG),
                         static_cast<float*>(dh), static_cast<float*>(param_parts),
                         static_cast<float*>(dparams), M, H, rows,
                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* gru_dv2_error_string(int code) {
  using namespace k1;
  static thread_local char buf[96];
  if (code == kErrNoEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code == kErrBadPlan) return "schedule does not fit the shape (see plan() in ops/gru_dv2.py)";
  if (code <= kErrEncodeBase) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed with CUresult %d",
             kErrEncodeBase - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
