// ssd_chunk: the Mamba2 SSD intra-chunk step, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunk_call` (src/repro/kernels/ssd_chunk.py,
// `_kernel`). Per (batch, head, chunk) cell, with cs = cumsum(dA):
//
//   L      = tril(exp(cs_i - cs_j))        (Q, Q)  causal decay matrix
//   y_diag = ((C B^T) . L) xdt             (Q, P)
//   state  = (xdt . exp(cs[-1] - cs))^T B  (P, N)  end-of-chunk state
//   decay  = exp(cs)                       (Q,)    incoming-state multiplier
//
// Layout (contiguous f32, no strides): xdt (b,h,nc,Q,P), dA (b,h,nc,Q),
// B and C (b,nc,Q,N) shared by every head (n_groups = 1); y (b,h,nc,Q,P),
// state (b,h,nc,P,N), decay (b,h,nc,Q). Q, N and P are runtime values: Q at
// most kMaxDim, N and P multiples of 4 up to kMaxDim, and xdt, B and C start
// on a 16-byte boundary (the wrapper checks all three).
//
// Design. One 256-thread block per cell. The grid is ordered with the head
// fastest, so the H blocks that share a (b, chunk) tile of B and C run side
// by side and read it from L2. A block stages B, C and xdt in shared memory
// (dynamic, up to ~193 KB: above the 48 KB static limit; 16-byte loads, so
// enough bytes are in flight with one block per SM), computes cs with one
// warp (in f64, rounded to f32), then three products, each a register-tiled
// loop in which thread (tr, tc) of an 8 x 32 layout owns rows tr + 8m and
// columns tc + 32n. Operands are (pointer, stride) pairs and edge rows are
// clamped, not guarded, so the inner loop is loads and FMAs with no branch:
//
//   (1) S = C B^T, masked: exp(cs_i - cs_j) is evaluated only for j <= i and
//       S is 0 above the diagonal, so an overflowing exp is never formed and
//       never multiplied by 0. S overwrites C's buffer once every thread has
//       finished reading C.
//   (2) y = S xdt.
//   (3) state = (xdt . w)^T B, with w = exp(cs[-1] - cs).
//
// Every output element is summed by one thread over k = 0, 1, ... in order,
// with f32 fmaf, so repeated launches are bitwise equal. Lanes of a warp
// share tr, so the A operand is a shared-memory broadcast; the B operand is
// read at 32 consecutive columns (B and C rows are padded to N + 1 floats, so
// product (1), which reads them along a row, is conflict-free too).
//
// Work. This kernel does the dense work of the TPU kernel: 2 Q^2 N + 2 Q^2 P
// + 2 Q P N f32 operations per cell (8,388,608 at Q = N = 128, P = 64), with
// C B^T formed once per head and S's upper triangle (all zeros) multiplied
// through. The outputs need less: C B^T once per (b, chunk) over its lower
// triangle, S xdt over the lower triangle (P Q (Q + 1) per cell) and the
// dense state (2 Q P N per cell), ~3.2e6 operations per cell at the full
// shape against (2 Q P + 2 Q + P N) * 4 bytes of its own plus B and C once
// per (b, chunk): ~31 operations per byte, above the card's f32 balance
// point (67e12 / 3.35e12 = 20), so bound by operations on the non-tensor f32
// pipe. Tensor cores (3xTF32 or wgmma), C B^T shared by the heads, the
// triangle only and TMA are the next steps; this kernel is the simple, exact
// first version.
//
// SSD_CUT = n (1, 2 or 3) builds a copy that returns just before product
// (n), which ssd_chunk_breakdown.py times; the kernel proper has it 0.
#ifndef SSD_CUT
#define SSD_CUT 0
#endif

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;    // tr in [0, 8)
constexpr int kColThreads = 32;   // tc in [0, 32): one warp spans the columns
constexpr int kMaxDim = 128;      // largest Q, N and P the tiles cover
constexpr int kMaxDevices = 64;

// An operand in shared memory: element (i, k) is p[i * stride + k * kstride],
// where i is a row of A or a column of B and k steps along the sum.
struct Operand {
  const float* p;
  int stride;
  int kstride;
};

// acc[m][n] = sum_k A(tr + 8m, k) * B(k, tc + 32n) over k = 0..depth-1 in
// order (A scaled by scale[k] first when kScaleA), for the rows < rows and
// columns < cols this thread owns; then, after a block-wide barrier when
// kSync, store(r, c, acc) for each of them. Rows and columns past the edge
// read the last valid one, so the loop has no branch; their sums are never
// stored. TM * 8 >= rows and TN * 32 >= cols must hold (product() picks).
template <int TM, int TN, bool kSync, bool kScaleA, class Store>
__device__ __forceinline__ void tile_product(int rows, int cols, int depth,
                                             Operand a, Operand b,
                                             const float* scale,
                                             Store store) {
  const int tr = threadIdx.x / kColThreads;
  const int tc = threadIdx.x % kColThreads;
  int aoff[TM], boff[TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
    aoff[m] = min(tr + m * kRowThreads, rows - 1) * a.stride;
#pragma unroll
  for (int n = 0; n < TN; ++n)
    boff[n] = min(tc + n * kColThreads, cols - 1) * b.stride;
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;
  const float* pa = a.p;
  const float* pb = b.p;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float av[TM], bv[TN];
    const float s = kScaleA ? scale[k] : 1.0f;
#pragma unroll
    for (int m = 0; m < TM; ++m) av[m] = kScaleA ? pa[aoff[m]] * s : pa[aoff[m]];
#pragma unroll
    for (int n = 0; n < TN; ++n) bv[n] = pb[boff[n]];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    pa += a.kstride;
    pb += b.kstride;
  }
  if (kSync) __syncthreads();
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = tr + m * kRowThreads;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = tc + n * kColThreads;
      if (r < rows && c < cols) store(r, c, acc[m][n]);
    }
  }
}

// In-place inclusive cumsum of v[0..n) (n <= 128) by one warp, accumulated
// in f64 and rounded to f32: lane l sums its run of ceil(n / 32) consecutive
// elements, a shuffle scan adds the runs of lanes below it. The f64 partial
// sums of f32 inputs are exact for dA's range (spreads under 2^29), so each
// cs[q] is the correctly rounded f32 of the exact sum whatever the order:
// the same bits as the plain version's f64 cumsum on the card or the CPU.
// cs feeds exp(cs_i - cs_j), where cs's own rounding (ulp(|cs|), ~2.4e-4 at
// |cs| ~ 2,700 when decays underflow) would otherwise set the error.
__device__ __forceinline__ void warp_cumsum(float* v, int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  double part[kMaxDim / 32];
  double run = 0.0;
#pragma unroll
  for (int t = 0; t < kMaxDim / 32; ++t) {
    const int q = lane * per + t;
    if (t < per && q < n) run += (double)v[q];
    part[t] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double below = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) below = 0.0;
#pragma unroll
  for (int t = 0; t < kMaxDim / 32; ++t) {
    const int q = lane * per + t;
    if (t < per && q < n) v[q] = (float)(below + part[t]);
  }
}

// Runs tile_product with the smallest tile (of 16 x 4, 16 x 2, 8 x 4 and
// 8 x 2 rows x columns per thread) that covers rows x cols; the choice is
// uniform across the block, so the barrier inside is reached by every thread.
template <bool kSync, bool kScaleA = false, class Store>
__device__ __forceinline__ void product(int rows, int cols, int depth,
                                        Operand a, Operand b,
                                        const float* scale, Store store) {
  const bool wide = cols > 2 * kColThreads;
  if (rows > 8 * kRowThreads) {
    if (wide)
      tile_product<16, 4, kSync, kScaleA>(rows, cols, depth, a, b, scale, store);
    else
      tile_product<16, 2, kSync, kScaleA>(rows, cols, depth, a, b, scale, store);
  } else {
    if (wide)
      tile_product<8, 4, kSync, kScaleA>(rows, cols, depth, a, b, scale, store);
    else
      tile_product<8, 2, kSync, kScaleA>(rows, cols, depth, a, b, scale, store);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                 const float* __restrict__ Bg, const float* __restrict__ Cg,
                 float* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ decay, int H, int nc, int Q, int P,
                 int N) {
  extern __shared__ float smem[];
  const int ld = N + 1;                       // padded row of B and C
  float* Bs = smem;                           // (Q, N + 1)
  float* Cs = Bs + Q * ld;                    // (Q, N + 1), then S (Q, Q)
  const int cs_elems = Q * ld > Q * Q ? Q * ld : Q * Q;
  float* xs = Cs + cs_elems;                  // (Q, P)
  float* cs = xs + Q * P;                     // (Q,) cumsum(dA)
  float* w = cs + Q;                          // (Q,) exp(cs[-1] - cs)

  // blockIdx.x = h + H * (c + nc * b): heads fastest
  const int64_t cell = blockIdx.x;            // (b, c, h) in row-major order
  const int h = (int)(cell % H);
  const int64_t bc = cell / H;                // b * nc + c
  const int c = (int)(bc % nc);
  const int64_t b = bc / nc;
  const int64_t row = (b * H + h) * nc + c;   // index of the (b, h, c) cell
  const float* xg = xdt + row * Q * P;
  const float* dAg = dA + row * Q;
  const float* Bt = Bg + bc * Q * N;
  const float* Ct = Cg + bc * Q * N;

  // 16-byte loads: N and P are multiples of 4 and the tiles start on a
  // 16-byte boundary (the wrapper checks both)
  const int n4 = N / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < Q * n4; i += kThreads) {
    const int q = i / n4, n = 4 * (i - q * n4);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(Bt) + i);
    const float4 cv = __ldg(reinterpret_cast<const float4*>(Ct) + i);
    float* bd = Bs + q * ld + n;
    float* cd = Cs + q * ld + n;
    bd[0] = bv.x; bd[1] = bv.y; bd[2] = bv.z; bd[3] = bv.w;
    cd[0] = cv.x; cd[1] = cv.y; cd[2] = cv.z; cd[3] = cv.w;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < Q * P / 4; i += kThreads) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(xg) + i);
    xs[4 * i] = v.x; xs[4 * i + 1] = v.y; xs[4 * i + 2] = v.z;
    xs[4 * i + 3] = v.w;
  }
  for (int q = threadIdx.x; q < Q; q += kThreads) cs[q] = __ldg(dAg + q);
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(cs, Q);
  __syncthreads();
  const float last = cs[Q - 1];
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    w[q] = expf(last - cs[q]);
    decay[row * Q + q] = expf(cs[q]);
  }
  __syncthreads();

#if SSD_CUT == 1
  return;
#endif
  // (1) S = (C B^T) . L, written over C once every thread is done reading C
  float* S = Cs;
  product<true>(
      Q, Q, N, Operand{Cs, ld, 1}, Operand{Bs, ld, 1}, nullptr,
      [&](int i, int j, float v) {
        S[i * Q + j] = j <= i ? v * expf(cs[i] - cs[j]) : 0.0f;
      });
  __syncthreads();

#if SSD_CUT == 2
  return;
#endif
  // (2) y = S xdt
  float* yc = y + row * Q * P;
  product<false>(Q, P, Q, Operand{S, Q, 1}, Operand{xs, 1, P}, nullptr,
                 [&](int i, int p, float v) { yc[i * P + p] = v; });

#if SSD_CUT == 3
  return;
#endif
  // (3) state = (xdt . w)^T B
  float* st = state + row * P * N;
  product<false, true>(P, N, Q, Operand{xs, 1, P}, Operand{Bs, 1, ld}, w,
                       [&](int p, int n, float v) { st[p * N + n] = v; });
}

size_t smem_bytes(int Q, int P, int N) {
  const size_t ld = (size_t)N + 1;
  const size_t s_elems = (size_t)Q * Q > Q * ld ? (size_t)Q * Q : Q * ld;
  return (Q * ld + s_elems + (size_t)Q * P + 2 * (size_t)Q) * sizeof(float);
}

}  // namespace

extern "C" {

// Largest Q, N and P the kernel takes; the wrapper raises beyond it.
int ssd_chunk_max_dim() { return kMaxDim; }

// Launches one block per (b, h, c) cell on `stream`, on the caller's current
// device, and returns cudaGetLastError(): a launch refused for its shared
// memory or grid never runs, and only this check reports it.
int ssd_chunk_launch(const float* xdt, const float* dA, const float* B,
                     const float* C, float* y, float* state, float* decay,
                     int64_t batch, int H, int nc, int Q, int P, int N,
                     void* stream) {
  // raise the kernel's dynamic shared memory limit to what the largest
  // cell needs, once per device, so no later launch (one inside a CUDA
  // graph capture, say) makes the call
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxDim, kMaxDim, kMaxDim));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const size_t smem = smem_bytes(Q, P, N);
  const int64_t cells = batch * H * nc;
  ssd_chunk_kernel<<<(unsigned)cells, kThreads, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      xdt, dA, B, C, y, state, decay, H, nc, Q, P, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
