// fused_cosine: (x.y, ||x||^2, ||y||^2) over a table of f32 leaf pairs, in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_cosine_2d` (src/repro/kernels/fused_cosine.py,
// `_kernel`): there the grid walks (rows, 1024) tiles of one concatenated
// vector in order on one core and carries a (1, 3) accumulator from step to
// step. Here the kernel reads a tree's leaves where they lie, and blocks run
// in parallel and in no order:
//
//   - the launch takes a table of up to kMaxSegs segments (x, y, n,
//     first_block, blocks) by value (__grid_constant__, so indexing it reads
//     the constant bank); a block finds its segment by a binary search over
//     first_block. A flat (n,) call is the one-segment table;
//   - each thread issues kUnroll independent float4 loads of each operand
//     before it consumes them (scalar loads where a segment's pointers are
//     not both 16-byte aligned), striding by the segment's block count;
//   - each block reduces its three f32 partials (warp shuffles, then shared
//     memory) to one (3,) row of a scratch buffer; one acquire-release
//     atomicInc ticket picks the last block to arrive, which sums every row in
//     block order and writes the triple (adding the previous launch's triple
//     first when a tree takes more than one table). atomicInc wraps the ticket
//     back to 0 in the same operation, so the next launch and every CUDA graph
//     replay find it at 0.
//
// No atomics touch the sums, and the blocks per segment are a function of the
// segment's length alone (kernels/leaf_table.py), so the same inputs at the
// same alignment give bitwise the same triple on every run: the 3SFC encoder's
// sign(s) and the EF residual stay repeatable.
//
// Bound on an H100 SXM: 3 FMAs per 8 bytes read, far below the card's balance
// point, so bytes: 2*n*4 at 3.35 TB/s (0.48 us at the MLP's n = 199,210). At
// that size the launch and a chain of dependent L2 round trips dominate (the
// loads, the partials row and its ticket, the last block's read of the rows);
// the design keeps the whole tree to one launch (no copy of the leaves, no
// second pass), has all of a one-wave grid's loads in flight at once (98
// blocks at the MLP's n), and orders the rows with one acquire-release atomic
// instead of two full fences.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kElemsPerBlock = kThreads * kUnroll * 4;
constexpr int kMaxSegs = 64;

struct Seg {
  const float* x;
  const float* y;
  int64_t n;
  int first_block;
  int blocks;
};
static_assert(sizeof(Seg) == 32, "B1 table entry");

struct Table {
  Seg seg[kMaxSegs];
  int count;
};
static_assert(sizeof(Table) < 4096, "B1 table over 4 KB");

__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
}

// Reduces the three per-thread partials of a kThreads block in a fixed order;
// thread 0 holds the block's sums on return. Callers separate two uses with a
// __syncthreads().
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

__device__ __forceinline__ void acc4(const float4 a, const float4 b, float& xy,
                                     float& xx, float& yy) {
  xy = fmaf(a.x, b.x, xy); xy = fmaf(a.y, b.y, xy);
  xy = fmaf(a.z, b.z, xy); xy = fmaf(a.w, b.w, xy);
  xx = fmaf(a.x, a.x, xx); xx = fmaf(a.y, a.y, xx);
  xx = fmaf(a.z, a.z, xx); xx = fmaf(a.w, a.w, xx);
  yy = fmaf(b.x, b.x, yy); yy = fmaf(b.y, b.y, yy);
  yy = fmaf(b.z, b.z, yy); yy = fmaf(b.w, b.w, yy);
}

// atomicInc at gpu scope with acquire-release order: it publishes this
// thread's partials row to the block that draws the last ticket, and that
// block's thread 0 sees every row (its __syncthreads() passes that on to the
// block). It wraps the ticket to 0 on the last increment.
__device__ __forceinline__ unsigned int ticket_inc(unsigned int* ticket,
                                                   unsigned int last) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(ticket), "r"(last) : "memory");
  return old;
}

// The segment that owns block b: the last one whose first_block <= b.
__device__ __forceinline__ const Seg& find_seg(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return t.seg[lo];
}

__global__ void __launch_bounds__(kThreads)
fused_cosine_table(const __grid_constant__ Table t,
                   float* __restrict__ partials, unsigned int* ticket,
                   float* __restrict__ out, int chain) {
  const Seg& sg = find_seg(t, blockIdx.x);
  port::grid_dependency_wait();
  const float* __restrict__ x = sg.x;
  const float* __restrict__ y = sg.y;
  const int64_t n = sg.n;
  const int64_t local = blockIdx.x - sg.first_block;
  float xy = 0.0f, xx = 0.0f, yy = 0.0f;
  int64_t head = 0;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const int64_t step = (int64_t)sg.blocks * kThreads * kUnroll;
    int64_t i = local * kThreads * kUnroll + threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < n4; i += step) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a[k] = __ldg(x4 + i + k * kThreads);
        b[k] = __ldg(y4 + i + k * kThreads);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc4(a[k], b[k], xy, xx, yy);
    }
    // at most one step is left, partly in range
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t j = i + k * kThreads;
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a[k] = j < n4 ? __ldg(x4 + j) : z;
      b[k] = j < n4 ? __ldg(y4 + j) : z;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc4(a[k], b[k], xy, xx, yy);
    head = n4 << 2;
  }
  // the last n % 4 elements of an aligned segment, or all of an unaligned one
  const int64_t sstride = (int64_t)sg.blocks * kThreads;
#pragma unroll 4
  for (int64_t i = head + local * kThreads + threadIdx.x; i < n;
       i += sstride) {
    const float a = __ldg(x + i);
    const float b = __ldg(y + i);
    xy = fmaf(a, b, xy);
    xx = fmaf(a, a, xx);
    yy = fmaf(b, b, yy);
  }
  block_sum3(xy, xx, yy);

  __shared__ unsigned int s_last;
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = xy;
    partials[3 * blockIdx.x + 1] = xx;
    partials[3 * blockIdx.x + 2] = yy;
    s_last = ticket_inc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every row, in block order
  float sxy = 0.0f, sxx = 0.0f, syy = 0.0f;
  for (int r = threadIdx.x; r < (int)gridDim.x; r += kThreads) {
    sxy += __ldcg(partials + 3 * r + 0);
    sxx += __ldcg(partials + 3 * r + 1);
    syy += __ldcg(partials + 3 * r + 2);
  }
  block_sum3(sxy, sxx, syy);
  if (threadIdx.x == 0) {
    if (chain) {
      sxy = out[0] + sxy;
      sxx = out[1] + sxx;
      syy = out[2] + syy;
    }
    out[0] = sxy;
    out[1] = sxx;
    out[2] = syy;
  }
}

cudaError_t launch(const int64_t* desc, int count, int blocks, float* partials,
                   unsigned int* ticket, float* out, int chain,
                   cudaStream_t stream) {
  Table t{};
  for (int k = 0; k < count; ++k) {
    const int64_t* d = desc + 5 * k;
    t.seg[k].x = reinterpret_cast<const float*>(d[0]);
    t.seg[k].y = reinterpret_cast<const float*>(d[1]);
    t.seg[k].n = d[2];
    t.seg[k].first_block = (int)d[3];
    t.seg[k].blocks = (int)d[4];
  }
  t.count = count;
  return port::launch_pdl(fused_cosine_table, (unsigned)blocks, kThreads,
                          stream, t, partials, ticket, out, chain);
}

}  // namespace

extern "C" {

int fused_cosine_max_segments() { return kMaxSegs; }
int fused_cosine_elems_per_block() { return kElemsPerBlock; }

// desc: `count` rows of (x, y, n, first_block, blocks) as int64, rows in
// block order, n >= 1 and blocks >= 1 each, 1 <= count <= kMaxSegs; `blocks`
// the sum of the rows' blocks. partials: blocks*3 f32 scratch; ticket: one
// u32 that is 0 between launches on `stream`; out: 3 f32, read first when
// `chain` is set. Launches on `stream` on `device` (the caller's current
// device is restored), with programmatic stream serialization, and returns
// the launch's error.
int fused_cosine_launch(const int64_t* desc, int count, int blocks,
                        float* partials, unsigned int* ticket, float* out,
                        int chain, int device, void* stream) {
  if (count < 1 || count > kMaxSegs || blocks < 1) return cudaErrorInvalidValue;
  return port::on_device(device, [&] {
    return launch(desc, count, blocks, partials, ticket, out, chain,
                  reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
