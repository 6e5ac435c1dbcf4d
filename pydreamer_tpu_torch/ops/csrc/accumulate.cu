// acc += g for a float32 accumulator and a bfloat16 addend of n elements:
// the step copies' gradient accumulation (ops/accumulate.py). One pass over
// HBM, 10 bytes an element: 16-byte loads of eight bf16 and of two float4,
// one 16-byte store each float4. Each sum is one f32 add of the exactly
// widened bf16, the rounding of torch's upcast-then-add.
//
// Plain C interface, loaded with ctypes: returns the CUDA error code of the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
add_bf16_into_f32(float* __restrict__ acc, const __nv_bfloat16* __restrict__ g, int64_t n) {
  const int64_t v = blockIdx.x * (int64_t)kThreads + threadIdx.x;  // the vector of 8 it adds
  const int64_t n8 = n / 8;
  if (v < n8) {
    const uint4 packed = __ldcs(reinterpret_cast<const uint4*>(g) + v);  // read once: stream
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&packed);
    float4* a = reinterpret_cast<float4*>(acc) + 2 * v;
    float4 a0 = a[0], a1 = a[1];
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    a0.x += f0.x; a0.y += f0.y; a0.z += f1.x; a0.w += f1.y;
    a1.x += f2.x; a1.y += f2.y; a1.z += f3.x; a1.w += f3.y;
    a[0] = a0;
    a[1] = a1;
  } else if (v - n8 < n % 8) {  // the last n % 8 elements, one a thread
    const int64_t k = n8 * 8 + (v - n8);
    acc[k] += __bfloat162float(g[k]);
  }
}

}  // namespace

// Both pointers start on 16 bytes; `stream` is a cudaStream_t.
extern "C" int accumulate_bf16_f32(void* acc, const void* g, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t threads = n / 8 + n % 8;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  add_bf16_into_f32<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<float*>(acc), static_cast<const __nv_bfloat16*>(g), n);
  return (int)cudaGetLastError();
}
