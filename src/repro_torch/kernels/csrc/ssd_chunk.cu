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
// What bounds it. The outputs need C B^T once per (b, chunk) over its lower
// triangle, S xdt over S's lower triangle and the dense state product:
// ~6.6 GFLOP at the full prefill shape (b, h, nc, Q, P, N) = (4, 32, 16,
// 128, 64, 128), against 212 MB that must move (each input read once, B
// and C once per (b, chunk), each output written once). On the tensor
// cores, even as three TF32 products, the operations would take less time
// than the bytes at the card's dense TF32 rate. With mma.sync, whose TF32
// rate is about half of that, and the split's own f32 work (each operand
// split, each S element's exp), the kernel is bound by the tensor cores'
// issue and the instructions around them, not by the bytes (PERF.md has
// the numbers, from ssd_chunk_breakdown.py). The design answers three
// faults of a first, scalar version (C B^T formed per head, S's zero upper
// triangle multiplied through, every product as f32 FMAs, and copies that
// nothing overlapped):
//
// 1. C B^T once per (b, chunk, head group), lower triangle only. A block of
//    8 warps owns one (b, chunk) and a group of G heads. It stages B and C,
//    forms G_cb = C B^T over 16 x 32 units that cover the tiles on or
//    below the diagonal (spread over the warps), and writes G_cb over C's
//    buffer once every warp has read C. Then it walks its G heads. S_h =
//    G_cb . L_h is never stored: each A fragment of S_h xdt_h is read from
//    G_cb and multiplied by exp(cs_i - cs_j) as it is loaded. Tiles above
//    the diagonal are skipped in both products. The launcher takes the
//    largest G of 16, 8, 4, 2, 1 that leaves at most a tenth of the SMs
//    without a block: at the full shape G = 16, 128 blocks in one wave on
//    132 SMs, C B^T formed twice per (b, chunk) instead of 32 times, and
//    the block's fixed work (staging B and C, C B^T) spread over 16 heads
//    (G = 8 gives two waves, each paying it). A short prompt (b * nc = 1)
//    gets G = 1: 32 blocks, the latency of one head.
// 2. Every product on the tensor cores as 3xTF32. Each f32 operand a is
//    split into big = a rounded to TF32 (10-bit mantissa) and small = a -
//    big (exact; the tensor core reads its top 19 bits), and each product
//    sums small.big + big.small + big.big with mma.sync.m16n8k8 (TF32
//    inputs, f32 accumulator). The dropped small.small term and the
//    truncation of small leave ~2^-21 of |a b| (plain TF32 keeps 2^-11 and
//    misses the reference's rtol 1e-4 at this depth). The tensor cores'
//    accumulation does not round to nearest, so they sum two k-steps from
//    zero, and each such sum is added to the running total in f32: the
//    results sit about as close to an f64 reference as the plain f32
//    version's.
//    Warps of the S xdt product take a short and a long row tile each (i
//    and nt-1-i), so the triangle loads every warp alike; the row tiles
//    share each k-step's xdt fragments. Edge tiles are clamped, not
//    guarded, so no inner loop branches.
// 3. Asynchronous staging. B, C and each head's xdt and dA are copied with
//    cp.async (16 bytes a thread; dA, whose rows need not be 16-byte
//    aligned, 4 bytes). xdt and dA are double-buffered: head h+1's copy is
//    in flight while head h is computed (single-buffered, with no overlap,
//    when two xdt tiles do not fit: P above 64 at Q = 128). Shared rows are
//    padded so that every fragment read is free of bank conflicts: rows read
//    along k at 4 mod 8 floats (C, G_cb), rows read across k at 8 mod 16
//    (xdt, and B in the state product; B's reads in C B^T, once per group,
//    take 2-way conflicts). Padding rows and columns are zero, so edge
//    k-steps add exact zeros, and every store is masked to the cell.
//
// Shared memory at the full shape: B 69.6 KB + C/G_cb 67.6 KB + 2 x xdt
// 36.9 KB + cs and w = 212.5 KB, one block per SM.
//
// Every output element is summed by one thread in a fixed order (k-steps in
// order, the three split products in order within each), with no atomics
// and no split of k across blocks, so repeated launches are bitwise equal,
// whatever G the launcher takes. exp(cs_i - cs_j) is formed only for j <=
// i (elsewhere exp(-inf) = 0), so no overflowing exp is formed; decays that
// underflow give zeros. The cumsum accumulates in f64 and rounds once
// (warp_cumsum).
//
// SSD_CUT = n builds a copy cut after a stage, which ssd_chunk_breakdown.py
// times: 1 = staging and the cumsums of every head only, 2 = also C B^T,
// 3 = also S xdt over the heads; the kernel proper (0) adds the state.
#ifndef SSD_CUT
#define SSD_CUT 0
#endif

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// S xdt: each of the 4 pairs of row tiles is split over kYCols warps by
// columns, kNT column tiles (of 8) per pass
constexpr int kYCols = kWarps / 4;
constexpr int kNT = 4;
// the state product's units: 2 row tiles x kSN column tiles (of 8)
constexpr int kSN = 4;
constexpr int kFlush = 2;         // k-steps summed on the tensor cores
constexpr int kMaxDim = 128;      // largest Q, N and P the tiles cover
constexpr int kMaxGroup = 16;     // heads per block at most
constexpr int kMaxDevices = 64;
// dynamic shared memory a block may opt into on sm_90 (227 KB)
constexpr int kSmemLimit = 232448;
// C B^T units (cb_unit) per warp at most
constexpr int kCbSlots = (20 + kWarps - 1) / kWarps;

constexpr bool kDoCB = SSD_CUT == 0 || SSD_CUT >= 2;
constexpr bool kDoY = SSD_CUT == 0 || SSD_CUT >= 3;
constexpr bool kDoState = SSD_CUT == 0;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory plan, in floats (every offset a multiple of 16 floats).
struct Layout {
  int Qp, Np, Pp;        // Q to 16, N to 8, P to 16
  int ldB, ldC, ldG, ldX;
  int offC, offX, xsize, offCs, offW, total;
};

__host__ __device__ inline Layout make_layout(int Q, int P, int N, int nbuf) {
  Layout l;
  l.Qp = round_up(Q, 16);
  l.Np = round_up(N, 8);
  l.Pp = round_up(P, 16);
  l.ldB = l.Np % 16 ? l.Np : l.Np + 8;   // 8 mod 16: read across k
  l.ldC = l.Np + 4;                      // 4 mod 8: read along k
  l.ldG = l.Qp + 4;
  l.ldX = l.Pp + 8;
  l.offC = l.Qp * l.ldB;
  const int cg = l.Qp * (l.ldC > l.ldG ? l.ldC : l.ldG);
  l.offX = l.offC + cg;
  l.xsize = l.Qp * l.ldX;
  l.offCs = l.offX + nbuf * l.xsize;
  l.offW = l.offCs + nbuf * l.Qp;
  l.total = l.offW + l.Qp;
  return l;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `pending` (0 or 1) of this thread's groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x cols (cols a multiple of 4) from contiguous global rows into
// shared rows of ld floats, 16 bytes a copy
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int rows,
                                           int cols) {
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int r = i / c4;
    cp_async16(dst + r * ld + 4 * (i - r * c4), src + 4 * i);
  }
}

// zeroes rows [rows, rows_p) x [0, cols_p) and [0, rows) x [cols, cols_p)
__device__ __forceinline__ void zero_pad(float* dst, int ld, int rows,
                                         int rows_p, int cols, int cols_p) {
  for (int i = threadIdx.x; i < (rows_p - rows) * cols_p; i += kThreads)
    dst[(rows + i / cols_p) * ld + i % cols_p] = 0.0f;
  const int w = cols_p - cols;
  if (w > 0)
    for (int i = threadIdx.x; i < rows * w; i += kThreads)
      dst[(i / w) * ld + cols + i % w] = 0.0f;
}

// a = big + small: big is a rounded to TF32 (half up in magnitude), small
// the exact rest; both as the 32-bit words mma reads
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// d += a b for one 16 x 8 x 8 TF32 tile, f32 accumulator. Fragments (g =
// lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b for one tile, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// d[r][n] (+)= a[r] b[n] in 3xTF32 for the first R row tiles and NT column
// tiles, from zero when `fresh`: every tile's small.big, then every
// big.small, then every big.big, so R * NT independent mmas separate two
// that depend on each other. Callers sum kFlush k-steps so on the tensor
// cores, whose accumulation does not round to nearest, and add that to
// their total in f32, rounded to nearest: the tensor cores never see the
// running total.
template <int R, int RA, int NT>
__device__ __forceinline__ void mma_tiles(float (&d)[RA][NT][4],
                                          const uint32_t (&ab)[RA][4],
                                          const uint32_t (&as)[RA][4],
                                          const uint32_t (&bb)[NT][2],
                                          const uint32_t (&bs)[NT][2],
                                          bool fresh) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (fresh)
        mma_tf32_zero(d[r][n], as[r], bb[n]);
      else
        mma_tf32(d[r][n], as[r], bb[n]);
    }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[r][n], ab[r], bs[n]);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[r][n], ab[r], bb[n]);
}

// acc += d over the first R row tiles, in f32
template <int R, int RA, int NT>
__device__ __forceinline__ void add_tiles(float (&acc)[RA][NT][4],
                                          const float (&d)[RA][NT][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] += d[r][n][e];
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], big[e], small[e]);
}

__device__ __forceinline__ void split2(float v0, float v1, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  split(v0, big[0], small[0]);
  split(v1, big[1], small[1]);
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

// C B^T work unit u: row tile i (16 rows) and column tiles 4q .. 4q+3 (of
// 8), q < (i + 2) / 2, so the units cover the tiles on or below the
// diagonal (and a few past it, in the last unit of a row)
__device__ __forceinline__ void cb_unit(int u, int& i, int& q) {
  int base = 0;
  i = 0;
  while (base + (i + 2) / 2 <= u) base += (i++ + 2) / 2;
  q = u - base;
}

__device__ __forceinline__ int cb_units(int ntq) {
  int n = 0;
  for (int i = 0; i < ntq; ++i) n += (i + 2) / 2;
  return n;
}

// (1) G_cb = C B^T over the tiles on or below the diagonal, k = N. Unit u
// (cb_unit) goes to warp u % kWarps; its B rows are clamped to the last
// tile, so the loop has no branch. Reads C and B; the caller writes the
// result over C after a barrier (store_cb).
__device__ __forceinline__ void cb_product(const float* Cs, int ldC,
                                           const float* Bs, int ldB, int ntq,
                                           int ksteps,
                                           float (&acc)[kCbSlots][1][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int units = cb_units(ntq);
#pragma unroll
  for (int s = 0; s < kCbSlots; ++s) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][0][n][e] = 0.0f;
    const int u = warp + kWarps * s;
    if (u >= units) continue;
    int i, q;
    cb_unit(u, i, q);
    const float* a0 = Cs + (16 * i + g) * ldC + t;
    const float* a1 = a0 + 8 * ldC;
    const float* b[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      b[n] = Bs + (8 * min(4 * q + n, 2 * ntq - 1) + g) * ldB + t;
    auto step = [&](int k, bool fresh, float (&d)[1][4][4]) {
      const int o = 8 * k;
      const float av[4] = {a0[o], a1[o], a0[o + 4], a1[o + 4]};
      uint32_t ab[1][4], as[1][4], bb[4][2], bs[4][2];
      split4(av, ab[0], as[0]);
#pragma unroll
      for (int n = 0; n < 4; ++n) split2(b[n][o], b[n][o + 4], bb[n], bs[n]);
      mma_tiles<1>(d, ab, as, bb, bs, fresh);
    };
    int k = 0;
    for (; k + 1 < ksteps; k += 2) {
      float d[1][4][4];
      step(k, true, d);
      step(k + 1, false, d);
      add_tiles<1>(acc[s], d);
    }
    if (k < ksteps) {
      float d[1][4][4];
      step(k, true, d);
      add_tiles<1>(acc[s], d);
    }
  }
}

__device__ __forceinline__ void store_cb(float* Gs, int ldG, int ntq,
                                         const float (&acc)[kCbSlots][1][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int units = cb_units(ntq);
#pragma unroll
  for (int s = 0; s < kCbSlots; ++s) {
    const int u = warp + kWarps * s;
    if (u >= units) continue;
    int i, q;
    cb_unit(u, i, q);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (4 * q + n > 2 * i + 1) continue;     // past the diagonal tile
      float* d = Gs + (16 * i + g) * ldG + 8 * (4 * q + n) + 2 * t;
      const float* a = acc[s][0][n];
      *reinterpret_cast<float2*>(d) = make_float2(a[0], a[1]);
      *reinterpret_cast<float2*>(d + 8 * ldG) = make_float2(a[2], a[3]);
    }
  }
}

// One k-step of y = S xdt for the first R of a warp's row tiles (rows[],
// with cs at their rows g and g + 8 in ci) and kNT column tiles (xdt
// columns at xoff[], clamped to the last tile, so the loop has no branch;
// clamped tiles are never stored). S's A fragments are G_cb(i, j) exp(cs_i
// - cs_j) for j <= i < Q, else 0 (exp(-inf)).
template <int R>
__device__ __forceinline__ void y_step(const float* Gs, int ldG,
                                       const float* xs, int ldX,
                                       const float* cs, int Q,
                                       const int (&rows)[2],
                                       const float (&ci)[2][2],
                                       const int (&xoff)[kNT], int kk,
                                       bool fresh, float (&d)[2][kNT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = 8 * kk + t, j1 = j0 + 4;
  const float* x0 = xs + j0 * ldX;
  uint32_t xb[kNT][2], xsm[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    split2(x0[xoff[n]], x0[4 * ldX + xoff[n]], xb[n], xsm[n]);
  const float cj0 = cs[j0], cj1 = cs[j1];
  uint32_t ab[2][4], as[2][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i0 = 16 * rows[r] + g, i1 = i0 + 8;
    const float* g0 = Gs + i0 * ldG;
    const float* g1 = g0 + 8 * ldG;
    const float v[4] = {
        g0[j0] * expf(j0 <= i0 && i0 < Q ? ci[r][0] - cj0 : -INFINITY),
        g1[j0] * expf(j0 <= i1 && i1 < Q ? ci[r][1] - cj0 : -INFINITY),
        g0[j1] * expf(j1 <= i0 && i0 < Q ? ci[r][0] - cj1 : -INFINITY),
        g1[j1] * expf(j1 <= i1 && i1 < Q ? ci[r][1] - cj1 : -INFINITY)};
    split4(v, ab[r], as[r]);
  }
  mma_tiles<R>(d, ab, as, xb, xsm, fresh);
}

// k-steps [k0, k1) (k1 - k0 a multiple of kFlush) for the first R row tiles
template <int R>
__device__ __forceinline__ void y_steps(const float* Gs, int ldG,
                                        const float* xs, int ldX,
                                        const float* cs, int Q,
                                        const int (&rows)[2],
                                        const float (&ci)[2][2],
                                        const int (&xoff)[kNT], int k0,
                                        int k1, float (&acc)[2][kNT][4]) {
  for (int kk = k0; kk < k1; kk += kFlush) {
    float d[2][kNT][4];
#pragma unroll
    for (int f = 0; f < kFlush; ++f)
      y_step<R>(Gs, ldG, xs, ldX, cs, Q, rows, ci, xoff, kk + f, f == 0, d);
    add_tiles<R>(acc, d);
  }
}

// (2) y = S xdt over S's lower triangle. Warp w takes row tiles pi = w / 2
// and nt-1-pi (one if they meet, none past the middle) and half the column
// tiles (w % 2), kNT at a time. The long row tile's k-steps cover the
// short one's, and each k-step's xdt fragments serve both.
__device__ __forceinline__ void y_product(int warp, const float* Gs, int ldG,
                                          const float* xs, int ldX,
                                          const float* cs, int Q, int P,
                                          int Qp, int Pp, float* yc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = Qp / 16;
  const int ra = warp / kYCols, rb = nt - 1 - ra;
  if (ra > rb) return;
  const int npt = Pp / 8, nper = (npt + kYCols - 1) / kYCols;
  const int nfirst = (warp % kYCols) * nper;
  const int nend = min(nfirst + nper, npt);
  const int rows[2] = {rb, ra};
  const bool two = ra != rb;
  float ci[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ci[r][0] = cs[16 * rows[r] + g];
    ci[r][1] = cs[16 * rows[r] + g + 8];
  }
  for (int n0 = nfirst; n0 < nend; n0 += kNT) {
    int xoff[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) xoff[n] = 8 * min(n0 + n, npt - 1) + g;
    float acc[2][kNT][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.0f;
    const int ks = two ? 2 * (ra + 1) : 0;
    y_steps<2>(Gs, ldG, xs, ldX, cs, Q, rows, ci, xoff, 0, ks, acc);
    y_steps<1>(Gs, ldG, xs, ldX, cs, Q, rows, ci, xoff, ks, 2 * (rb + 1),
               acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) break;
      const int i0 = 16 * rows[r] + g;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int col = 8 * (n0 + n) + 2 * t;
        if (n0 + n >= nend || col >= P) continue;
        if (i0 < Q)
          *reinterpret_cast<float2*>(yc + i0 * P + col) =
              make_float2(acc[r][n][0], acc[r][n][1]);
        if (i0 + 8 < Q)
          *reinterpret_cast<float2*>(yc + (i0 + 8) * P + col) =
              make_float2(acc[r][n][2], acc[r][n][3]);
      }
    }
  }
}

// (3) state = (xdt . w)^T B, dense, k = Q. Units of 2 row tiles (32 p) x 4
// column tiles (32 n) go to warp u % kWarps; w is applied as A is loaded.
// Tiles past the edge are clamped to the last one, so the loop has no
// branch; they are never stored.
__device__ __forceinline__ void state_product(int warp, const float* xs,
                                              int ldX, const float* Bs,
                                              int ldB, const float* w, int P,
                                              int N, int Qp, int Pp, int Np,
                                              float* st) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = Pp / 16, nnt = Np / 8;
  const int ngr = (nnt + kSN - 1) / kSN;
  for (int u = warp; u < (mt + 1) / 2 * ngr; u += kWarps) {
    const int m0 = 2 * (u / ngr), nb = kSN * (u % ngr);
    int aoff[2], boff[kSN];
#pragma unroll
    for (int r = 0; r < 2; ++r) aoff[r] = 16 * min(m0 + r, mt - 1) + g;
#pragma unroll
    for (int n = 0; n < kSN; ++n) boff[n] = 8 * min(nb + n, nnt - 1) + g;
    float acc[2][kSN][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < kSN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.0f;
    for (int k0 = 0; k0 < Qp / 8; k0 += kFlush) {
      float d[2][kSN][4];
#pragma unroll
      for (int f = 0; f < kFlush; ++f) {
        const int q0 = 8 * (k0 + f) + t;
        const float w0 = w[q0], w1 = w[q0 + 4];
        const float* x0 = xs + q0 * ldX;
        const float* x1 = x0 + 4 * ldX;
        uint32_t ab[2][4], as[2][4], bb[kSN][2], bs[kSN][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float av[4] = {x0[aoff[r]] * w0, x0[aoff[r] + 8] * w0,
                               x1[aoff[r]] * w1, x1[aoff[r] + 8] * w1};
          split4(av, ab[r], as[r]);
        }
        const float* b0 = Bs + q0 * ldB;
        const float* b1 = b0 + 4 * ldB;
#pragma unroll
        for (int n = 0; n < kSN; ++n)
          split2(b0[boff[n]], b1[boff[n]], bb[n], bs[n]);
        mma_tiles<2>(d, ab, as, bb, bs, f == 0);
      }
      add_tiles<2>(acc, d);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p0 = 16 * (m0 + r) + g;
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        const int col = 8 * (nb + n) + 2 * t;
        if (m0 + r >= mt || nb + n >= nnt || col >= N) continue;
        if (p0 < P)
          *reinterpret_cast<float2*>(st + p0 * N + col) =
              make_float2(acc[r][n][0], acc[r][n][1]);
        if (p0 + 8 < P)
          *reinterpret_cast<float2*>(st + (p0 + 8) * N + col) =
              make_float2(acc[r][n][2], acc[r][n][3]);
      }
    }
  }
}

// One block per (b, chunk, group of G heads); blockIdx.x = grp + groups *
// (c + nc * b).
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ dA,
                 const float* __restrict__ Bg, const float* __restrict__ Cg,
                 float* __restrict__ y, float* __restrict__ state,
                 float* __restrict__ decay, int H, int nc, int Q, int P,
                 int N, int G, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = make_layout(Q, P, N, nbuf);
  float* Bs = smem;
  float* Cs = smem + l.offC;              // C, then G_cb
  float* xbuf = smem + l.offX;            // nbuf x (Qp, ldX)
  float* csbuf = smem + l.offCs;          // nbuf x (Qp,): dA, then cs
  float* w = smem + l.offW;               // (Qp,) exp(cs[-1] - cs)

  const int groups = (H + G - 1) / G;
  const int grp = (int)(blockIdx.x % groups);
  const int64_t bc = blockIdx.x / groups;   // b * nc + c
  const int c = (int)(bc % nc);
  const int64_t b = bc / nc;
  const int h0 = grp * G;
  const int nh = min(G, H - h0);

  auto cell = [&](int hh) { return (b * H + h0 + hh) * nc + c; };
  auto stage_head = [&](int hh, int buf) {
    const int64_t row = cell(hh);
    stage_rows(xbuf + buf * l.xsize, l.ldX, xdt + row * Q * P, Q, P);
    for (int q = threadIdx.x; q < Q; q += kThreads)
      cp_async4(csbuf + buf * l.Qp + q, dA + row * Q + q);
  };

  stage_rows(Bs, l.ldB, Bg + bc * Q * N, Q, N);
  stage_rows(Cs, l.ldC, Cg + bc * Q * N, Q, N);
  stage_head(0, 0);
  cp_async_commit();
  if (nbuf == 2) {
    if (nh > 1) stage_head(1, 1);
    cp_async_commit();
  }
  zero_pad(Bs, l.ldB, Q, l.Qp, N, l.Np);
  zero_pad(Cs, l.ldC, Q, l.Qp, N, l.Np);
  for (int k = 0; k < nbuf; ++k)
    zero_pad(xbuf + k * l.xsize, l.ldX, Q, l.Qp, P, l.Pp);
  for (int q = Q + threadIdx.x; q < l.Qp; q += kThreads) w[q] = 0.0f;
  cp_async_wait(nbuf - 1);
  __syncthreads();

  if (kDoCB) {
    float acc[kCbSlots][1][4][4];
    cb_product(Cs, l.ldC, Bs, l.ldB, l.Qp / 16, l.Np / 8, acc);
    __syncthreads();                        // every warp is done with C
    store_cb(Cs, l.ldG, l.Qp / 16, acc);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int hh = 0; hh < nh; ++hh) {
    const int buf = nbuf == 2 ? hh & 1 : 0;
    if (hh > 0) cp_async_wait(nbuf - 1);
    __syncthreads();                        // head hh landed; G_cb stored
    float* cs = csbuf + buf * l.Qp;
    const float* xs = xbuf + buf * l.xsize;
    const int64_t row = cell(hh);
    if (warp == 0) {
      warp_cumsum(cs, Q);
      __syncwarp();
      const float last = cs[Q - 1];
      for (int q = lane; q < Q; q += 32) {
        w[q] = expf(last - cs[q]);
        decay[row * Q + q] = expf(cs[q]);
      }
    }
    __syncthreads();
    if (kDoY)
      y_product(warp, Cs, l.ldG, xs, l.ldX, cs, Q, P, l.Qp, l.Pp,
                y + row * Q * P);
    if (kDoState)
      state_product(warp, xs, l.ldX, Bs, l.ldB, w, P, N, l.Qp, l.Pp, l.Np,
                    state + row * P * N);
    __syncthreads();                        // done with buf, cs and w
    if (hh + nbuf < nh) stage_head(hh + nbuf, buf);
    cp_async_commit();
  }
}

size_t smem_bytes(int Q, int P, int N, int nbuf) {
  return (size_t)make_layout(Q, P, N, nbuf).total * sizeof(float);
}

}  // namespace

extern "C" {

// Largest Q, N and P the kernel takes; the wrapper raises beyond it.
int ssd_chunk_max_dim() { return kMaxDim; }

// Launches one block per (b, chunk, group of heads) on `stream`, on the
// caller's current device, and returns cudaGetLastError(): a launch refused
// for its shared memory or grid never runs, and only this check reports it.
int ssd_chunk_launch(const float* xdt, const float* dA, const float* B,
                     const float* C, float* y, float* state, float* decay,
                     int64_t batch, int H, int nc, int Q, int P, int N,
                     void* stream) {
  // opt into the largest dynamic shared memory once per device, so no
  // later launch (one inside a CUDA graph capture, say) makes the call
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    int count = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int nbuf = smem_bytes(Q, P, N, 2) <= (size_t)kSmemLimit ? 2 : 1;
  const size_t smem = smem_bytes(Q, P, N, nbuf);
  // the most heads per block that leaves at most a tenth of the SMs
  // without a block
  int G = kMaxGroup;
  while (G > 1 && 10 * batch * nc * ((H + G - 1) / G) < 9 * sms[dev]) G /= 2;
  const int64_t blocks = batch * nc * ((H + G - 1) / G);
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      xdt, dA, B, C, y, state, decay, H, nc, Q, P, N, G, nbuf);
  return (int)cudaGetLastError();
}

}  // extern "C"
