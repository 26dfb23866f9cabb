// sign_quant: signSGD's int8 signs and mean |x| of one f32 vector, in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `sign_quant_2d` (src/repro/kernels/sign_quant.py,
// `_kernel`): there the grid walks (rows, 1024) tiles in order on one core,
// writes each tile's int8 signs and carries sum |x| in a (1, 1) accumulator
// from step to step; the wrapper divides by n. Here blocks run in parallel
// and in no order:
//
//   - the grid is at most one wave (as many blocks as the card holds at
//     once, from the occupancy API) and strides past it; each thread takes
//     kStep consecutive elements per step, as independent float4 loads, and
//     writes their signs as one 8-byte store (scalar loads or stores where x
//     or the signs are off a 16-byte boundary, and for the last, partial
//     step);
//   - each block reduces its threads' f32 partials of |x| (warp shuffles,
//     then shared memory) to one partial, which it writes into its slot of a
//     scratch buffer with a flag bit set, and draws a ticket (atomicInc). The
//     block that draws the last ticket reads every slot at once, re-reading a
//     slot until its flag shows (no fence orders the slot before the ticket),
//     sums the partials in block order, clears the slots and writes sum / n,
//     so the scale never goes through the host. atomicInc wraps the ticket
//     back to 0 in the same operation: the next launch and every CUDA graph
//     replay find the ticket at 0 and every slot clear;
//   - the launch sets programmatic dependent launch (csrc/launch.cuh): the
//     grid may start while the previous kernel on its stream drains, and
//     waits before its first global access; each block then lets the next
//     launch on the stream be scheduled at once (it waits in turn).
//
// No atomics touch the sum, and the block count is a function of n and the
// card alone (kernels/one_wave.py), so the same input at the same alignment
// gives bitwise the same scale on every run.
//
// Numerics: the reference computes with subnormals flushed to zero (XLA's CPU
// runtime runs with FTZ/DAZ, a TPU has none), so jnp.sign(1e-40) is 0. Each
// value is flushed here explicitly before its sign and its |x| are taken; the
// build's flags stay those of the other kernels. The sign is three-valued:
// +1, -1, and 0 for a zero (or NaN), unlike bitpack's 1-bit sign.
//
// Bound on an H100 SXM: one compare and one add per element against 5 bytes
// moved (4 read, 1 written), so bytes: 5n at 3.35 TB/s, 0.30 us at the MLP's
// n = 199,210 and 6.3 us at 4 Mi + 5. At the smaller size the launch and a
// chain of L2 round trips dominate (the loads, the ticket, the last block's
// read of the slots); the design keeps the call to one launch, every load of
// a step in flight at once, and no memory fence on the chain. Trials on the
// card chose 8 elements per step over 16 or 32, and a thread's consecutive
// elements over a warp's coalesced float4s regrouped through shared memory.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 8;                    // elements per thread per step
constexpr int kTile = kThreads * kStep;     // elements per block per step
constexpr int kMaxRows = 8;                 // slots per thread of the sum
constexpr int kMaxBlocks = kThreads * kMaxRows;
constexpr unsigned long long kFlag = 1ull << 32;   // a slot holds a partial

__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

// The three-valued sign of a flushed value, as the byte of an int8.
__device__ __forceinline__ uint32_t sign_byte(float f) {
  return (uint32_t)(uint8_t)(signed char)((f > 0.f) - (f < 0.f));
}

// Sums one f32 per thread of a kThreads block in a fixed order; thread 0
// holds the block's sum on return. Callers separate two uses with a
// __syncthreads().
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

// Lets the next launch on the stream be scheduled now; it still waits in
// its own grid_dependency_wait() for this grid to complete.
__device__ __forceinline__ void trigger_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// A slot's store and load: single-copy atomic (strong, gpu scope), unordered
// with anything else.
__device__ __forceinline__ void st_slot(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_slot(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__global__ void __launch_bounds__(kThreads)
sign_quant_kernel(const float* __restrict__ x, signed char* __restrict__ signs,
                  unsigned long long* slots, unsigned int* ticket,
                  float* __restrict__ scale, int64_t n, float nf, int vec_x,
                  int vec_s) {
  port::grid_dependency_wait();
  trigger_dependents();
  float asum = 0.0f;
  const int64_t steps = (n + kStep - 1) / kStep;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x; c < steps;
       c += stride) {
    const int64_t e0 = c * kStep;
    const bool full = e0 + kStep <= n;
    float v[kStep];
    if (full && vec_x) {
      const float4* p = reinterpret_cast<const float4*>(x + e0);
      float4 q[kStep / 4];
#pragma unroll
      for (int k = 0; k < kStep / 4; ++k) q[k] = __ldg(p + k);
#pragma unroll
      for (int k = 0; k < kStep / 4; ++k) {
        v[4 * k + 0] = q[k].x;
        v[4 * k + 1] = q[k].y;
        v[4 * k + 2] = q[k].z;
        v[4 * k + 3] = q[k].w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kStep; ++i)
        v[i] = e0 + i < n ? __ldg(x + e0 + i) : 0.0f;
    }
    // little-endian words of four sign bytes each; |x| in element order
    uint32_t w[kStep / 4];
#pragma unroll
    for (int k = 0; k < kStep / 4; ++k) {
      w[k] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = flush_subnormal(v[4 * k + i]);
        w[k] |= sign_byte(f) << (8 * i);
        asum += fabsf(f);
      }
    }
    if (full && vec_s) {
      *reinterpret_cast<uint2*>(signs + e0) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kStep; ++i)
        if (e0 + i < n)
          signs[e0 + i] = (signed char)(w[i / 4] >> (8 * (i % 4)));
    }
  }
  asum = block_sum(asum);

  __shared__ unsigned int s_last;
  if (threadIdx.x == 0) {
    st_slot(slots + blockIdx.x, kFlag | __float_as_uint(asum));
    s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every slot, loaded at once, summed in block order
  unsigned long long p[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int r = threadIdx.x + i * kThreads;
    p[i] = r < (int)gridDim.x ? ld_slot(slots + r) : kFlag;
  }
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int r = threadIdx.x + i * kThreads;
    while (!(p[i] & kFlag)) p[i] = ld_slot(slots + r);
    total += __uint_as_float((unsigned int)p[i]);
    if (r < (int)gridDim.x) slots[r] = 0;
  }
  total = block_sum(total);
  if (threadIdx.x == 0) scale[0] = total / nf;
}

}  // namespace

extern "C" {

// Elements per block per step; the wrapper sizes the grid from it.
int sign_quant_tile() { return kTile; }

// Blocks of one wave of sign_quant_kernel on `device` (at most the
// kMaxBlocks slots the last block sums), into *wave.
int sign_quant_wave(int device, int* wave) {
  return port::on_device(device, [&] {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sign_quant_kernel, kThreads, 0);
    if (err == cudaSuccess) {
      const int w = sms * (per_sm > 0 ? per_sm : 1);
      *wave = w < kMaxBlocks ? w : kMaxBlocks;
    }
    return err;
  });
}

// x: n f32 (n >= 1); signs: n int8; slots: `blocks` u64, all 0 between
// launches on `stream`; ticket: one u32, 0 between launches on `stream`;
// scale: 1 f32 = sum |flush(x)| / n. 1 <= blocks <= one wave. Launches on
// `stream` on `device` (the caller's current device is restored), with
// programmatic stream serialization, and returns the launch's error.
int sign_quant_launch(const float* x, signed char* signs,
                      unsigned long long* slots, unsigned int* ticket,
                      float* scale, int64_t n, int blocks, int device,
                      void* stream) {
  if (n < 1 || blocks < 1 || blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  const int vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int vec_s = (reinterpret_cast<uintptr_t>(signs) & 7) == 0;
  return port::on_device(device, [&] {
    return port::launch_pdl(sign_quant_kernel, (unsigned)blocks, kThreads,
                            reinterpret_cast<cudaStream_t>(stream), x, signs,
                            slots, ticket, scale, n, (float)n, vec_x, vec_s);
  });
}

}  // extern "C"
