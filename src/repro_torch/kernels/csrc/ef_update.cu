// ef_update: the error-feedback residual e' = u - s*d over a table of f32
// leaves, in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ef_update_2d` (src/repro/kernels/ef_update.py,
// `_kernel`), which streams (rows, 1024) tiles of one concatenated u and d and
// takes s as a (1, 1) block. Here the launch takes a table of up to kMaxSegs
// segments (u, d, out, n, first_block, blocks) by value (__grid_constant__)
// and reads and writes every leaf where it lies: a block finds its segment by
// a binary search over first_block, and each thread issues kUnroll independent
// float4 loads of u and of d before it stores kUnroll float4 of e' (scalar
// accesses where a segment's three pointers are not all 16-byte aligned),
// striding by the segment's block count. A flat (n,) call is the one-segment
// table. s stays on the device (a 1-element tensor): no host sync to read it.
//
// Each element is one fmaf(-s, d, u), rounded once, whatever the partition:
// a tree's result is bitwise the flat kernel's on the concatenated operands.
// The plain PyTorch version rounds s*d and the difference separately, so the
// two may differ by one rounding of the result.
//
// Bound on an H100 SXM: no arithmetic to speak of, so bytes: 3*n*4 at 3.35
// TB/s (0.71 us at the MLP's n = 199,210). At that size the launch dominates;
// the design makes a tree one launch with no copy of the leaves in or out.
// Two float4 of each operand per thread (256 threads) rather than four (128):
// the same 2,048 elements per block step as B1, and the shorter chain of
// loads before each thread's stores measured faster at the MLP's n.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kElemsPerBlock = kThreads * kUnroll * 4;
constexpr int kMaxSegs = 64;

struct Seg {
  const float* u;
  const float* d;
  float* out;
  int64_t n;
  int first_block;
  int blocks;
};
static_assert(sizeof(Seg) == 40, "B2 table entry");

struct Table {
  Seg seg[kMaxSegs];
  int count;
};
static_assert(sizeof(Table) < 4096, "B2 table over 4 KB");

// The segment that owns block b: the last one whose first_block <= b.
__device__ __forceinline__ const Seg& find_seg(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return t.seg[lo];
}

__device__ __forceinline__ float4 residual4(const float s, const float4 a,
                                            const float4 b) {
  float4 r;
  r.x = fmaf(-s, b.x, a.x);
  r.y = fmaf(-s, b.y, a.y);
  r.z = fmaf(-s, b.z, a.z);
  r.w = fmaf(-s, b.w, a.w);
  return r;
}

__global__ void __launch_bounds__(kThreads)
ef_update_table(const __grid_constant__ Table t,
                const float* __restrict__ s_ptr) {
  const Seg& sg = find_seg(t, blockIdx.x);
  port::grid_dependency_wait();
  const float* __restrict__ u = sg.u;
  const float* __restrict__ d = sg.d;
  float* __restrict__ out = sg.out;
  const int64_t n = sg.n;
  const int64_t local = blockIdx.x - sg.first_block;
  const float s = __ldg(s_ptr);
  int64_t head = 0;
  if (((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(d) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    const int64_t n4 = n >> 2;
    const float4* u4 = reinterpret_cast<const float4*>(u);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int64_t step = (int64_t)sg.blocks * kThreads * kUnroll;
    int64_t i = local * kThreads * kUnroll + threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < n4; i += step) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a[k] = __ldg(u4 + i + k * kThreads);
        b[k] = __ldg(d4 + i + k * kThreads);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        o4[i + k * kThreads] = residual4(s, a[k], b[k]);
    }
    // at most one step is left, partly in range
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t j = i + k * kThreads;
      if (j < n4) {
        a[k] = __ldg(u4 + j);
        b[k] = __ldg(d4 + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t j = i + k * kThreads;
      if (j < n4) o4[j] = residual4(s, a[k], b[k]);
    }
    head = n4 << 2;
  }
  // the last n % 4 elements of an aligned segment, or all of an unaligned one
  const int64_t sstride = (int64_t)sg.blocks * kThreads;
#pragma unroll 4
  for (int64_t i = head + local * kThreads + threadIdx.x; i < n;
       i += sstride) {
    out[i] = fmaf(-s, __ldg(d + i), __ldg(u + i));
  }
}

cudaError_t launch(const int64_t* desc, int count, int blocks, const float* s,
                   cudaStream_t stream) {
  Table t{};
  for (int k = 0; k < count; ++k) {
    const int64_t* e = desc + 6 * k;
    t.seg[k].u = reinterpret_cast<const float*>(e[0]);
    t.seg[k].d = reinterpret_cast<const float*>(e[1]);
    t.seg[k].out = reinterpret_cast<float*>(e[2]);
    t.seg[k].n = e[3];
    t.seg[k].first_block = (int)e[4];
    t.seg[k].blocks = (int)e[5];
  }
  t.count = count;
  return port::launch_pdl(ef_update_table, (unsigned)blocks, kThreads, stream,
                          t, s);
}

}  // namespace

extern "C" {

int ef_update_max_segments() { return kMaxSegs; }
int ef_update_elems_per_block() { return kElemsPerBlock; }

// desc: `count` rows of (u, d, out, n, first_block, blocks) as int64, rows in
// block order, n >= 1 and blocks >= 1 each, 1 <= count <= kMaxSegs; `blocks`
// the sum of the rows' blocks; s: one f32 on the device. Launches on `stream`
// on `device` (the caller's current device is restored), with programmatic
// stream serialization, and returns the launch's error.
int ef_update_launch(const int64_t* desc, int count, int blocks,
                     const float* s, int device, void* stream) {
  if (count < 1 || count > kMaxSegs || blocks < 1) return cudaErrorInvalidValue;
  return port::on_device(device, [&] {
    return launch(desc, count, blocks, s,
                  reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
