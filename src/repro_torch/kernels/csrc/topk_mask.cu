// topk_mask: DGC's threshold select over one f32 vector, for Hopper (sm_90a):
// out = (|x| >= tau) ? x : 0, and the count of kept elements.
//
// Replaces the TPU kernel `topk_mask_2d` (src/repro/kernels/topk_mask.py,
// `_kernel`): there the grid walks (rows, 1024) tiles in order on one core,
// writes each masked tile and carries the kept count, as an f32 sum, in a
// (1, 1) accumulator; the wrapper `ops.topk_mask` first raises tau to at
// least 1e-38 so that the tiles' zero padding never passes. Here the vector
// is not padded, and the count is an exact integer taken in two passes:
//
//   pass 1 (topk_mask_partials): a grid-stride loop, a float4 load and a
//     float4 store per thread where x and out are 16-byte aligned (a scalar
//     loop otherwise, and for the tail); every thread counts its kept
//     elements; a warp-shuffle then shared-memory reduction writes one
//     64-bit count per block;
//   pass 2 (topk_mask_finish): one block sums the counts in a fixed order and
//     writes the total as f32 (exact below 2**24, as the reference's f32 sum
//     is).
//
// tau is read on the device (a 0-d tensor from `ops.topk_threshold`), never
// synced to the host.
//
// Numerics: the reference computes with subnormals flushed to zero (XLA's CPU
// runtime runs with FTZ/DAZ, a TPU has none). So its floor of 1e-38, itself
// subnormal, is 0; a subnormal |x| compares as 0; and a kept element writes
// x's own bits (the select does not flush). Both flushes are written out
// here: keep = |flush(x)| >= flush(max(tau, 1e-38)), where max propagates a
// NaN tau as torch.maximum does; the build's flags stay those of the other
// kernels.
//
// Bound on an H100 SXM: one compare per element against 8 bytes moved (4
// read, 4 written), so bytes: 8n at 3.35 TB/s, 0.48 us at the MLP's
// n = 199,210 and 10.0 us at 4 Mi + 5. At the smaller size the launch latency
// of the two passes dominates; the design keeps the first pass to one
// coalesced read of x and one write of out.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

__device__ __forceinline__ float masked(float v, float t, long long& kept) {
  const bool keep = fabsf(flush_subnormal(v)) >= t;
  kept += keep;
  return keep ? v : 0.0f;
}

// Sums one count per thread of a kThreads block; thread 0 holds the block's
// sum on return.
__device__ __forceinline__ long long block_sum(long long a) {
  __shared__ long long smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  if (lane == 0) smem[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? smem[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
topk_mask_partials(const float* __restrict__ x, const float* __restrict__ tau,
                   float* __restrict__ out, long long* __restrict__ partials,
                   int64_t n, int vec) {
  const float t0 = __ldg(tau);
  const float t = flush_subnormal(t0 != t0 ? t0 : fmaxf(t0, 1e-38f));
  long long kept = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      o4[i] = make_float4(masked(v.x, t, kept), masked(v.y, t, kept),
                          masked(v.z, t, kept), masked(v.w, t, kept));
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    out[i] = masked(__ldg(x + i), t, kept);
  kept = block_sum(kept);
  if (threadIdx.x == 0) partials[blockIdx.x] = kept;
}

__global__ void __launch_bounds__(kThreads)
topk_mask_finish(const long long* __restrict__ partials,
                 float* __restrict__ count, int rows) {
  long long kept = 0;
  for (int r = threadIdx.x; r < rows; r += kThreads) kept += partials[r];
  kept = block_sum(kept);
  if (threadIdx.x == 0) count[0] = (float)kept;
}

}  // namespace

extern "C" {

// Threads per block of both passes; the wrapper sizes the grid and the
// scratch from it.
int topk_mask_threads() { return kThreads; }

// x, out: n f32 each (n >= 1); tau: 1 f32 on the device; partials: blocks
// int64 scratch; count: 1 f32. Launches both passes on `stream`, on the
// caller's current device, and returns cudaGetLastError().
int topk_mask_launch(const float* x, const float* tau, float* out,
                     long long* partials, float* count, int64_t n,
                     int64_t blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  topk_mask_partials<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, tau, out, partials, n, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_mask_finish<<<1, kThreads, 0, s>>>(partials, count, (int)blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
