// sign_quant: signSGD's int8 signs and mean |x| of one f32 vector, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `sign_quant_2d` (src/repro/kernels/sign_quant.py,
// `_kernel`): there the grid walks (rows, 1024) tiles in order on one core,
// writes each tile's int8 signs and carries sum |x| in a (1, 1) accumulator
// from step to step; the wrapper divides by n. Here blocks run in parallel
// and in no order, so the sum is taken in two passes, as in fused_cosine:
//
//   pass 1 (sign_quant_partials): a grid-stride loop, a float4 load and a
//     char4 store per thread where x is 16-byte aligned (a scalar loop
//     otherwise, and for the tail); every thread keeps one f32 partial of
//     |x|; a warp-shuffle then shared-memory reduction writes one partial
//     per block;
//   pass 2 (sign_quant_finish): one block sums the partials in a fixed order
//     and writes sum / n, so the scale never goes through the host.
//
// No atomics, and the block count is a function of n alone (the wrapper picks
// it), so the same input gives bitwise the same scale on every run.
//
// Numerics: the reference computes with subnormals flushed to zero (XLA's CPU
// runtime runs with FTZ/DAZ, a TPU has none), so jnp.sign(1e-40) is 0. Each
// value is flushed here explicitly before its sign and its |x| are taken; the
// build's flags stay those of the other kernels. The sign is three-valued:
// +1, -1, and 0 for a zero (or NaN), unlike bitpack's 1-bit sign.
//
// Bound on an H100 SXM: one compare and one add per element against 5 bytes
// moved (4 read, 1 written), so bytes: 5n at 3.35 TB/s, 0.30 us at the MLP's
// n = 199,210 and 6.3 us at 4 Mi + 5. At the smaller size the launch latency
// of the two passes dominates; the design keeps the first pass to one
// coalesced read of x and one write of the signs.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

__device__ __forceinline__ signed char sign_of(float f) {
  return (signed char)((f > 0.f) - (f < 0.f));
}

// Sums one f32 per thread of a kThreads block in a fixed order; thread 0
// holds the block's sum on return.
__device__ __forceinline__ float block_sum(float a) {
  __shared__ float smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  if (lane == 0) smem[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? smem[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
sign_quant_partials(const float* __restrict__ x, signed char* __restrict__ signs,
                    float* __restrict__ partials, int64_t n, int vec) {
  float asum = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* s4 = reinterpret_cast<char4*>(signs);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      const float a = flush_subnormal(v.x), b = flush_subnormal(v.y);
      const float c = flush_subnormal(v.z), d = flush_subnormal(v.w);
      s4[i] = make_char4(sign_of(a), sign_of(b), sign_of(c), sign_of(d));
      asum += fabsf(a);
      asum += fabsf(b);
      asum += fabsf(c);
      asum += fabsf(d);
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    const float a = flush_subnormal(__ldg(x + i));
    signs[i] = sign_of(a);
    asum += fabsf(a);
  }
  asum = block_sum(asum);
  if (threadIdx.x == 0) partials[blockIdx.x] = asum;
}

__global__ void __launch_bounds__(kThreads)
sign_quant_finish(const float* __restrict__ partials, float* __restrict__ scale,
                  int rows, float n) {
  float asum = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kThreads) asum += partials[r];
  asum = block_sum(asum);
  if (threadIdx.x == 0) scale[0] = asum / n;
}

}  // namespace

extern "C" {

// Threads per block of both passes; the wrapper sizes the grid and the
// scratch from it.
int sign_quant_threads() { return kThreads; }

// x: n f32 (n >= 1); signs: n int8; partials: blocks f32 scratch; scale: 1
// f32 = sum |flush(x)| / n. Launches both passes on `stream`, on the caller's
// current device, and returns cudaGetLastError().
int sign_quant_launch(const float* x, signed char* signs, float* partials,
                      float* scale, int64_t n, int64_t blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // the char4 stores need signs 4-byte aligned; the wrapper's fresh
  // allocation always is
  const int vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                  ((reinterpret_cast<uintptr_t>(signs) & 3) == 0);
  sign_quant_partials<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, signs, partials, n, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sign_quant_finish<<<1, kThreads, 0, s>>>(partials, scale, (int)blocks,
                                           (float)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
