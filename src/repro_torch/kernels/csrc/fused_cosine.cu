// fused_cosine: (x.y, ||x||^2, ||y||^2) over two f32 vectors, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_cosine_2d` (src/repro/kernels/fused_cosine.py,
// `_kernel`): there the grid walks (rows, 1024) tiles in order on one core and
// carries a (1, 3) accumulator from step to step. Here blocks run in parallel
// and in no order, so the sum is taken in two passes:
//
//   pass 1 (fused_cosine_partials): a grid-stride loop, float4 loads where both
//     operands are 16-byte aligned and a scalar tail; every thread keeps three
//     f32 partials; a warp-shuffle then shared-memory reduction writes one (3,)
//     row per block into a (blocks, 3) scratch buffer;
//   pass 2 (fused_cosine_finish): one block sums the rows in a fixed order.
//
// No atomics, and the block count is a function of n alone (the wrapper picks
// it), so the same inputs give bitwise the same triple on every run: the 3SFC
// encoder's sign(s) and the EF residual stay repeatable.
//
// Bound on an H100 SXM: the operation is 3 FMAs per 8 bytes read, far below the
// card's balance point, so it is bound by bytes: 2*n*4 bytes at 3.35 TB/s
// (0.48 us at the MLP's n = 199,210). At that size the launch latency of the
// two passes (a few us) dominates; the design keeps the first pass to one
// coalesced read of each operand and the second to `blocks`*3 floats.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
}

// Reduces the three per-thread partials of a kThreads block in a fixed order;
// thread 0 holds the block's sums on return.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
  __shared__ float smem[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sum3(a, b, c);
  if (lane == 0) {
    smem[0][warp] = a;
    smem[1][warp] = b;
    smem[2][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? smem[0][lane] : 0.0f;
    b = lane < kWarps ? smem[1][lane] : 0.0f;
    c = lane < kWarps ? smem[2][lane] : 0.0f;
    warp_sum3(a, b, c);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_cosine_partials(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ partials, int64_t n, int vec) {
  float xy = 0.0f, xx = 0.0f, yy = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = __ldg(x4 + i);
      const float4 b = __ldg(y4 + i);
      xy = fmaf(a.x, b.x, xy); xy = fmaf(a.y, b.y, xy);
      xy = fmaf(a.z, b.z, xy); xy = fmaf(a.w, b.w, xy);
      xx = fmaf(a.x, a.x, xx); xx = fmaf(a.y, a.y, xx);
      xx = fmaf(a.z, a.z, xx); xx = fmaf(a.w, a.w, xx);
      yy = fmaf(b.x, b.x, yy); yy = fmaf(b.y, b.y, yy);
      yy = fmaf(b.z, b.z, yy); yy = fmaf(b.w, b.w, yy);
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    const float a = __ldg(x + i);
    const float b = __ldg(y + i);
    xy = fmaf(a, b, xy);
    xx = fmaf(a, a, xx);
    yy = fmaf(b, b, yy);
  }
  block_sum3(xy, xx, yy);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = xy;
    partials[3 * blockIdx.x + 1] = xx;
    partials[3 * blockIdx.x + 2] = yy;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_cosine_finish(const float* __restrict__ partials, float* __restrict__ out,
                    int rows) {
  float xy = 0.0f, xx = 0.0f, yy = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    xy += partials[3 * r + 0];
    xx += partials[3 * r + 1];
    yy += partials[3 * r + 2];
  }
  block_sum3(xy, xx, yy);
  if (threadIdx.x == 0) {
    out[0] = xy;
    out[1] = xx;
    out[2] = yy;
  }
}

}  // namespace

extern "C" {

// Threads per block of both passes; the wrapper sizes the grid and the
// (blocks, 3) scratch from it.
int fused_cosine_threads() { return kThreads; }

// x, y: n f32 each (n >= 1); partials: blocks*3 f32 scratch; out: 3 f32.
// Launches both passes on `stream`, on the caller's current device, and
// returns cudaGetLastError().
int fused_cosine_launch(const float* x, const float* y, float* partials,
                        float* out, int64_t n, int64_t blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  fused_cosine_partials<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, y, partials, n, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_cosine_finish<<<1, kThreads, 0, s>>>(partials, out, (int)blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
