// topk_mask: DGC's threshold select over one f32 vector, in one launch, for
// Hopper (sm_90a): out = (|x| >= tau) ? x : 0, and the count of kept
// elements.
//
// Replaces the TPU kernel `topk_mask_2d` (src/repro/kernels/topk_mask.py,
// `_kernel`): there the grid walks (rows, 1024) tiles in order on one core,
// writes each masked tile and carries the kept count, as an f32 sum, in a
// (1, 1) accumulator; the wrapper `ops.topk_mask` first raises tau to at
// least 1e-38 so that the tiles' zero padding never passes. Here the vector
// is not padded, blocks run in parallel and in no order, and the count is an
// exact integer:
//
//   - the grid is at most one wave (as many blocks as the card holds at
//     once, from the occupancy API) and strides past it; per step each
//     thread loads one float4, coalesced across the block, with a hint that
//     L2 fetch the 256 bytes around it, and writes one float4 (scalar loads
//     or stores where x or out is off a 16-byte boundary, and for the last
//     n % 4 elements);
//   - each warp counts its kept elements with __popc(__ballot_sync(...)),
//     one ballot per element position, and each block sums its warps' counts
//     into one 64-bit count. One relaxed 64-bit atomicAdd per block carries
//     both a ticket (bits 40 and up) and the count (bits 0-39) into one word
//     of scratch: the block that draws the last ticket holds the total in
//     the word's old value plus its own count, writes it as f32 (exact below
//     2**24, as the reference's f32 sum is) and sets the word back to 0 for
//     the next launch and every CUDA graph replay. An integer sum is the
//     same in any order, so no block reads another's count and no fence is
//     needed;
//   - the launch sets programmatic dependent launch (csrc/launch.cuh): the
//     grid may start while the previous kernel on its stream drains (often
//     the one that wrote tau), and waits before its first global access;
//     each block then lets the next launch on the stream be scheduled at
//     once (it waits in turn).
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
// n = 199,210 and 10.0 us at 4 Mi + 5. At the smaller size the launch and one
// chain of L2 round trips dominate (the loads, then the one atomic); the
// design keeps the call to one launch and the chain to one atomic past the
// loads. Trials on the card chose one float4 per thread per step over two or
// four.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * 4;     // elements per block per step
constexpr unsigned int kFull = 0xffffffffu;
// the scratch word: a count in bits 0-39, the blocks done from bit 40 up
constexpr int kCountBits = 40;
constexpr unsigned long long kTicket = 1ull << kCountBits;

__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

// Elements 4j .. 4j+3 of x, 0 past n; a whole float4 is loaded with a hint
// that L2 fetch the 256 bytes around it.
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        int64_t j, int64_t n, int vec) {
  const int64_t e = 4 * j;
  if (vec && e + 4 <= n) {
    float4 v;   // volatile: never hoisted above grid_dependency_wait()
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0,%1,%2,%3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(reinterpret_cast<const float4*>(x) + j));
    return v;
  }
  float c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = e + i < n ? __ldg(x + e + i) : 0.0f;
  return make_float4(c[0], c[1], c[2], c[3]);
}

// Writes elements 4j .. 4j+3 of out that are below n.
__device__ __forceinline__ void store4(float* __restrict__ out, int64_t j,
                                       int64_t n, int vec, float4 v) {
  const int64_t e = 4 * j;
  if (vec && e + 4 <= n) {
    reinterpret_cast<float4*>(out)[j] = v;
    return;
  }
  const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (e + i < n) out[e + i] = c[i];
}

// Keeps v if it is one of the n elements and |flush(v)| >= t; adds the
// warp's kept count at this position to `kept` (every lane the same).
__device__ __forceinline__ float keep_or_zero(float v, bool real, float t,
                                              unsigned long long& kept) {
  const bool keep = real && fabsf(flush_subnormal(v)) >= t;
  kept += __popc(__ballot_sync(kFull, keep));
  return keep ? v : 0.0f;
}

// Lets the next launch on the stream be scheduled now; it still waits in
// its own grid_dependency_wait() for this grid to complete.
__device__ __forceinline__ void trigger_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const float* __restrict__ x, const float* __restrict__ tau,
                 float* __restrict__ out, unsigned long long* acc,
                 float* __restrict__ count, int64_t n, int vec_x, int vec_o) {
  __shared__ unsigned long long s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  port::grid_dependency_wait();
  trigger_dependents();
  const float t0 = __ldg(tau);
  const float t = flush_subnormal(t0 != t0 ? t0 : fmaxf(t0, 1e-38f));
  // the warp's count; the loop bounds are block-uniform, so every lane
  // reaches every ballot
  unsigned long long kept = 0;
  const int64_t slots = (n + 3) >> 2;         // float4 slots, the last partial
  const int64_t steps = (slots + kThreads - 1) / kThreads;
  for (int64_t s = blockIdx.x; s < steps; s += gridDim.x) {
    const int64_t j = s * kThreads + threadIdx.x;
    const int64_t e = 4 * j;
    const float4 v = load4(x, j, n, vec_x);
    const float4 o = make_float4(keep_or_zero(v.x, e + 0 < n, t, kept),
                                 keep_or_zero(v.y, e + 1 < n, t, kept),
                                 keep_or_zero(v.z, e + 2 < n, t, kept),
                                 keep_or_zero(v.w, e + 3 < n, t, kept));
    if (j < slots) store4(out, j, n, vec_o, o);
  }
  if (lane == 0) s_warp[warp] = kept;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long block = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) block += s_warp[w];
  const unsigned long long old = atomicAdd(acc, kTicket + block);
  if ((old >> kCountBits) == gridDim.x - 1) {
    count[0] = (float)((old & (kTicket - 1)) + block);
    *acc = 0;
  }
}

}  // namespace

extern "C" {

// Elements per block per step; the wrapper sizes the grid from it.
int topk_mask_tile() { return kTile; }

// Blocks of one wave of topk_mask_kernel on `device`, into *wave.
int topk_mask_wave(int device, int* wave) {
  return port::on_device(device, [&] {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, topk_mask_kernel, kThreads, 0);
    if (err == cudaSuccess) *wave = sms * (per_sm > 0 ? per_sm : 1);
    return err;
  });
}

// x, out: n f32 each (1 <= n < 2**40); tau: 1 f32 on the device; acc: one
// u64 that is 0 between launches on `stream`; count: 1 f32. 1 <= blocks <=
// one wave (< 2**24). Launches on `stream` on `device` (the caller's current
// device is restored), with programmatic stream serialization, and returns
// the launch's error.
int topk_mask_launch(const float* x, const float* tau, float* out,
                     unsigned long long* acc, float* count, int64_t n,
                     int blocks, int device, void* stream) {
  if (n < 1 || n >= (int64_t)kTicket || blocks < 1 || blocks >= (1 << 24))
    return cudaErrorInvalidValue;
  const int vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int vec_o = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return port::on_device(device, [&] {
    return port::launch_pdl(topk_mask_kernel, (unsigned)blocks, kThreads,
                            reinterpret_cast<cudaStream_t>(stream), x, tau,
                            out, acc, count, n, vec_x, vec_o);
  });
}

}  // extern "C"
