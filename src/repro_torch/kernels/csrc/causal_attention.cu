// causal_attention: causal grouped self-attention with an f32 softmax, forward
// and backward, for Hopper (sm_90a). Kernel B7 of the port.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA
// (src/repro/models/attention.py `_sdpa`, einsums around an f32 softmax),
// and the port's `models/attention.py` `_sdpa` wrote the same einsums out.
// On the card those einsums write the (H, S, S) logits to device memory in
// f32 and read and write them again for the scale, the mask, the softmax
// and each cast, forward and backward: at qwen1.5-0.5b's 16 heads x 4,096
// positions ~33 GB a sequence-layer under the per-layer remat, which made
// those elementwise passes most of a training round. This kernel keeps
// every logit and probability on chip.
//
// Layout: q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, DV), bf16, each
// with its own (batch, position, head) strides in elements and its last
// dimension contiguous; query head h reads KV head h / G (G = H / KV, heads
// grouped contiguously). Outputs are contiguous: o and dq (B, S, H, ·),
// dk and dv (B, S, KV, ·), bf16; the row statistics m, l and the backward's
// D are f32 (B, H, S). (D, DV) is one of (64, 64), (128, 128), (192, 128).
//
// The arithmetic is the reference's, rounding point for rounding point:
//   s  = bf16(q.k) -> f32, times scale (1/sqrt(f32 D)), -1e30 where key > query
//   m  = max_j s,  l = sum_j exp(s - m)            (f32)
//   p  = exp(s - m) / l                            (f32, normalised before
//                                                   the cast, as the softmax
//                                                   is)
//   o  = bf16(sum_j bf16(p) v)                     (f32 accumulators)
// backward, from the stored m and l:
//   dP = bf16(dO.v) -> f32,  D = sum_j p dP        (the f32 p, as softmax's
//                                                   backward takes it)
//   dS = bf16(p (dP - D) scale)
//   dq = bf16(dS k),  dk = bf16(dS^T q),  dv = bf16(bf16(p)^T dO)
// so the forward walks the keys twice (m and l first, then the normalised
// p and p.v), at the cost of a second q.k product.
//
// What bounds it. With the logits on chip, what is left is tensor-core
// work: per (batch, head) the causal half of the S x S products, 3 of
// them forward (q.k twice, p.v) and 9 backward (q.k and dO.v twice and
// dS.k for dq and D; q.k, dO.v, p.dO and dS.q for dk and dv), against
// bytes of O(S (D + DV)) per head. The design:
//
// 1. Tiles at or below the diagonal only. A block owns 64 queries of one
//    (batch, head) and walks the key tiles up to the diagonal (dk/dv: 64
//    keys, walking the query tiles from the diagonal down); tiles above it
//    are skipped, which leaves nothing out: in f32 exp(-1e30 - m) is 0.
//    Only the tile on the diagonal (and a ragged last tile) is masked.
//    The heaviest blocks are launched first.
// 2. Products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//    accumulators in registers). Each warp owns 16 rows; operands come
//    from shared memory through ldmatrix, and a product's C fragments are
//    re-packed in registers as the A fragments of the next product (p for
//    p.v, dS for dS.k), so no probability ever leaves the warp.
// 3. Key (or query) tiles are staged by cp.async in a ring of two stages:
//    the next tile's copy runs under the current tile's products. Rows sit
//    in shared memory with their 16-byte chunks swizzled (chunk ^ row % 8),
//    so every ldmatrix reads eight distinct banks.
// 4. Every sum runs in a fixed order with no atomics: dq (and D) in one
//    kernel over query tiles, dk and dv in another over key tiles, each
//    output element summed by one thread in the same order on every run.
//    Two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr int kTile = 64;           // queries a forward / dq block owns

struct Strides {
  long long b, s, h;   // batch, position, head; in elements
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0 bytes read: the chunk is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element (r, c) of a shared tile of rows of W bf16: the row's 16-byte
// chunks are permuted by chunk ^ (r % 8). W is a multiple of 64.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

// Stages rows [r0, r0 + ROWS) of a (rows, W) operand with row stride rs
// into a swizzled tile; rows at or past S are zero-filled.
template <int ROWS, int W, int NT>
__device__ __forceinline__ void tile_load(bf16* sm, const bf16* g,
                                          long long rs, int r0, int S,
                                          int tid) {
  constexpr int C = W / 8, N = ROWS * C;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int i = it * NT + tid;
    if (N % NT == 0 || i < N) {
      const int r = i / C, c = (i % C) * 8, gr = r0 + r;
      const bool ok = gr < S;
      cp_async16(smem_addr(sm + swz<W>(r, c)),
                 g + (long long)(ok ? gr : 0) * rs + c, ok);
    }
  }
}

// acc (16 x N) += A (16 x K, rows r0.. of a swizzled tile of width WA) times
// Bt^T, Bt an (N x K) swizzled tile of width WB.
template <int K, int N, int WA, int WB>
__device__ __forceinline__ void gemm_ss_nt(float (&acc)[N / 8][4],
                                           const bf16* sA, int r0,
                                           const bf16* sB, int lane) {
  const uint32_t a_base = smem_addr(sA), b_base = smem_addr(sB);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, a_base + 2 * swz<WA>(r0 + (lane & 15),
                                  kk * 16 + ((lane >> 4) << 3)));
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];
      ldsm4(b, b_base + 2 * swz<WB>(nn * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    kk * 16 + (((lane >> 3) & 1) << 3)));
      mma(acc[2 * nn], a, b[0], b[1]);
      mma(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x N) += A (16 x K, A fragments in registers) times Bt^T, Bt an
// (N x K) swizzled tile of width WB.
template <int K, int N, int WB>
__device__ __forceinline__ void gemm_rs_nt(float (&acc)[N / 8][4],
                                           const uint32_t (&a)[K / 16][4],
                                           const bf16* sB, int lane) {
  const uint32_t b_base = smem_addr(sB);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];
      ldsm4(b, b_base + 2 * swz<WB>(nn * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    kk * 16 + (((lane >> 3) & 1) << 3)));
      mma(acc[2 * nn], a[kk], b[0], b[1]);
      mma(acc[2 * nn + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x N) += A (16 x K, A fragments in registers) times B, B a (K x N)
// swizzled tile of width WB (read transposed by ldmatrix).
template <int K, int N, int WB>
__device__ __forceinline__ void gemm_rs_nn(float (&acc)[N / 8][4],
                                           const uint32_t (&a)[K / 16][4],
                                           const bf16* sB, int lane) {
  const uint32_t b_base = smem_addr(sB);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t b[4];
      ldsm4t(b, b_base + 2 * swz<WB>(kk * 16 + (lane & 7) +
                                         (((lane >> 3) & 1) << 3),
                                     nn * 16 + ((lane >> 4) << 3)));
      mma(acc[2 * nn], a[kk], b[0], b[1]);
      mma(acc[2 * nn + 1], a[kk], b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// C fragments of a (16 x K) product as the A fragments of the next product
// over K: n-tiles 2kk and 2kk+1 make k-step kk.
template <int K>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[K / 16][4],
                                           const float (&c)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The logits as the reference rounds them: bf16(q.k) -> f32, times scale,
// kNegInf where the key (column) lies after the query (row). Rows are the
// thread's row_lo and row_lo + 8, columns col0 + 8 nt + 2 (lane % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void logits_rows(float (&s)[N][4], float scale,
                                            bool mask, int row_lo, int col0,
                                            int lane) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = bf16_round(s[nt][e]) * scale;
      if (mask) {
        const int row = row_lo + (e >> 1) * 8;
        const int col = col0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        if (col > row) x = kNegInf;
      }
      s[nt][e] = x;
    }
}

// Per head-dimension pair: the key tile of the forward, of dq's walk, and
// the query tile of dk/dv's walk (the widest pairs take narrower tiles to
// stay within 255 registers); and each kernel's minimum resident blocks a
// SM, which caps its registers. At (64, 64) the softmax's scalar work
// (expf, an IEEE division, the bf16 roundings) outweighs the products, so
// more resident warps hide its latency: 4, 3, 3 blocks (128, 168, 168
// registers) time 0.43 / 1.20 ms against 0.53 / 1.41 ms uncapped (forward
// / backward at S = 4,096, 16 heads, H100). The wider pairs spill under a
// cap and run slower, so they take 1.
template <int D, int DV> struct Tiles {
  static constexpr bool narrow = D + DV <= 128;
  static constexpr int fwd_bn = 64;
  static constexpr int dq_bn = narrow ? 64 : 32;
  static constexpr int dkv_bm = narrow ? 64 : 32;
  static constexpr int fwd_blocks = narrow ? 4 : 1;
  static constexpr int dq_blocks = narrow ? 3 : 1;
  static constexpr int dkv_blocks = narrow ? 3 : 1;
};

// ---------------------------------------------------------------------------
// forward: o, m, l. Block: BM queries of one (batch, head), BM / 16 warps.
// ---------------------------------------------------------------------------

template <int D, int DV, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, (Tiles<D, DV>::fwd_blocks))
    attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
             bf16* __restrict__ o, float* __restrict__ mo,
             float* __restrict__ lo, int H, int G, int S, float scale) {
  constexpr int NT = BM * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * D;        // two stages
  bf16* sV = sK + 2 * BN * D;    // two stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const bf16* qg = q + b * sq.b + h * sq.h;
  const bf16* kg = k + b * sk.b + kh * sk.h;
  const bf16* vg = v + b * sv.b + kh * sv.h;
  const int nkb = (min(S, q0 + BM) + BN - 1) / BN;
  const int r0 = warp * 16;
  const int row_lo = q0 + r0 + (lane >> 2);

  tile_load<BM, D, NT>(sQ, qg, sq.s, q0, S, tid);
  tile_load<BN, D, NT>(sK, kg, sk.s, 0, S, tid);
  cp_commit();

  uint32_t qf[D / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // pass 1: each row's max m and sum l of exp(s - m), online
  for (int j = 0; j < nkb; ++j) {
    if (j + 1 < nkb) {
      tile_load<BN, D, NT>(sK + ((j + 1) & 1) * BN * D, kg, sk.s,
                           (j + 1) * BN, S, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm4(qf[kk], smem_addr(sQ + swz<D>(r0 + (lane & 15),
                                            kk * 16 + ((lane >> 4) << 3))));
    }
    float s[BN / 8][4];
    zero(s);
    gemm_rs_nt<D, BN, D>(s, qf, sK + (j & 1) * BN * D, lane);
    logits_rows(s, scale, (j + 1) * BN > q0, row_lo, j * BN, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sum += expf(s[nt][2 * i] - mn);
        sum += expf(s[nt][2 * i + 1] - mn);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[i] = l_run[i] * expf(m_run[i] - mn) + sum;
      m_run[i] = mn;
    }
    __syncthreads();
  }

  // pass 2: p = exp(s - m) / l and o = sum bf16(p) v
  float oacc[DV / 8][4];
  zero(oacc);
  tile_load<BN, D, NT>(sK, kg, sk.s, 0, S, tid);
  tile_load<BN, DV, NT>(sV, vg, sv.s, 0, S, tid);
  cp_commit();
  for (int j = 0; j < nkb; ++j) {
    if (j + 1 < nkb) {
      const int st = (j + 1) & 1;
      tile_load<BN, D, NT>(sK + st * BN * D, kg, sk.s, (j + 1) * BN, S, tid);
      tile_load<BN, DV, NT>(sV + st * BN * DV, vg, sv.s, (j + 1) * BN, S,
                            tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[BN / 8][4];
    zero(s);
    gemm_rs_nt<D, BN, D>(s, qf, sK + (j & 1) * BN * D, lane);
    logits_rows(s, scale, (j + 1) * BN > q0, row_lo, j * BN, lane);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = expf(s[nt][e] - m_run[e >> 1]) / l_run[e >> 1];
    uint32_t pf[BN / 16][4];
    to_a_frags<BN>(pf, s);
    gemm_rs_nn<BN, DV, DV>(oacc, pf, sV + (j & 1) * BN * DV, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    if (row >= S) continue;
    bf16* orow = o + ((long long)(b * S + row) * H + h) * DV;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * (lane & 3)) =
          pack_bf16(oacc[nt][2 * i], oacc[nt][2 * i + 1]);
    if ((lane & 3) == 0) {
      const long long at = (long long)(b * H + h) * S + row;
      mo[at] = m_run[i];
      lo[at] = l_run[i];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq and D: BM queries of one (batch, head), walking the keys.
// ---------------------------------------------------------------------------

template <int D, int DV, int BM, int BN>
__global__ void __launch_bounds__(BM * 2, (Tiles<D, DV>::dq_blocks))
    attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                Strides sq, Strides sk, Strides sv, Strides sdo,
                const float* __restrict__ mi, const float* __restrict__ li,
                bf16* __restrict__ dq, float* __restrict__ Dout, int H, int G,
                int S, float scale) {
  constexpr int NT = BM * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BM * D;        // dO
  bf16* sK = sO + BM * DV;       // two stages
  bf16* sV = sK + 2 * BN * D;    // two stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* qg = q + b * sq.b + h * sq.h;
  const bf16* og = dout + b * sdo.b + h * sdo.h;
  const bf16* kg = k + b * sk.b + kh * sk.h;
  const bf16* vg = v + b * sv.b + kh * sv.h;
  const int nkb = (min(S, q0 + BM) + BN - 1) / BN;
  const int r0 = warp * 16;
  const int row_lo = q0 + r0 + (lane >> 2);
  const long long stat0 = (long long)(b * H + h) * S;

  float m_row[2], l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    m_row[i] = row < S ? mi[stat0 + row] : 0.f;
    l_row[i] = row < S ? li[stat0 + row] : 1.f;
  }

  tile_load<BM, D, NT>(sQ, qg, sq.s, q0, S, tid);
  tile_load<BM, DV, NT>(sO, og, sdo.s, q0, S, tid);
  float D_row[2] = {0.f, 0.f};
  float dqacc[D / 8][4];
  zero(dqacc);

  // pass 0 sums D = sum_j p dP; pass 1 forms dS and dq = dS k
  for (int pass = 0; pass < 2; ++pass) {
    tile_load<BN, D, NT>(sK, kg, sk.s, 0, S, tid);
    tile_load<BN, DV, NT>(sV, vg, sv.s, 0, S, tid);
    cp_commit();
    for (int j = 0; j < nkb; ++j) {
      if (j + 1 < nkb) {
        const int st = (j + 1) & 1;
        tile_load<BN, D, NT>(sK + st * BN * D, kg, sk.s, (j + 1) * BN, S,
                             tid);
        tile_load<BN, DV, NT>(sV + st * BN * DV, vg, sv.s, (j + 1) * BN, S,
                              tid);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* sKj = sK + (j & 1) * BN * D;
      const bf16* sVj = sV + (j & 1) * BN * DV;
      float s[BN / 8][4], dp[BN / 8][4];
      zero(s);
      zero(dp);
      gemm_ss_nt<D, BN, D, D>(s, sQ, r0, sKj, lane);
      gemm_ss_nt<DV, BN, DV, DV>(dp, sO, r0, sVj, lane);
      logits_rows(s, scale, (j + 1) * BN > q0, row_lo, j * BN, lane);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = expf(s[nt][e] - m_row[i]) / l_row[i];
          const float d = bf16_round(dp[nt][e]);
          if (pass == 0)
            D_row[i] += p * d;
          else
            s[nt][e] = (p * (d - D_row[i])) * scale;
        }
      if (pass == 1) {
        uint32_t sf[BN / 16][4];
        to_a_frags<BN>(sf, s);
        gemm_rs_nn<BN, D, D>(dqacc, sf, sKj, lane);
      }
      __syncthreads();
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        D_row[i] += __shfl_xor_sync(0xffffffffu, D_row[i], 1);
        D_row[i] += __shfl_xor_sync(0xffffffffu, D_row[i], 2);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    if (row >= S) continue;
    bf16* drow = dq + ((long long)(b * S + row) * H + h) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(drow + nt * 8 + 2 * (lane & 3)) =
          pack_bf16(dqacc[nt][2 * i], dqacc[nt][2 * i + 1]);
    if ((lane & 3) == 0) Dout[stat0 + row] = D_row[i];
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: BN keys of one (batch, KV head), walking the G query
// heads of its group and their query tiles from the diagonal on. Warps own
// key rows, so each product is formed transposed (keys x queries).
// ---------------------------------------------------------------------------

template <int D, int DV, int BN, int BM>
__global__ void __launch_bounds__(BN * 2, (Tiles<D, DV>::dkv_blocks))
    attn_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  Strides sq, Strides sk, Strides sv, Strides sdo,
                  const float* __restrict__ mi, const float* __restrict__ li,
                  const float* __restrict__ Di, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int H, int G, int S, float scale) {
  constexpr int NT = BN * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * D;
  bf16* sQ = sV + BN * DV;       // two stages
  bf16* sO = sQ + 2 * BM * D;    // two stages (dO)
  float* sStat = reinterpret_cast<float*>(sO + 2 * BM * DV);  // 2 x (m, l, D)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KV = H / G;
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int k0 = blockIdx.y * BN;              // lowest keys first: heaviest
  const bf16* kg = k + b * sk.b + kh * sk.h;
  const bf16* vg = v + b * sv.b + kh * sv.h;
  const int r0 = warp * 16;
  const int key_lo = k0 + r0 + (lane >> 2);
  const int qt0 = k0 / BM, nqt = (S + BM - 1) / BM;
  const int per_head = nqt - qt0, total = G * per_head;

  auto stage = [&](int t, int st) {
    const int h = kh * G + t / per_head, i0 = (qt0 + t % per_head) * BM;
    tile_load<BM, D, NT>(sQ + st * BM * D, q + b * sq.b + h * sq.h, sq.s, i0,
                         S, tid);
    tile_load<BM, DV, NT>(sO + st * BM * DV, dout + b * sdo.b + h * sdo.h,
                          sdo.s, i0, S, tid);
    cp_commit();
    const long long stat0 = (long long)(b * H + h) * S;
    for (int c = tid; c < BM; c += NT) {
      const int row = i0 + c;
      float* at = sStat + st * 3 * BM;
      at[c] = row < S ? mi[stat0 + row] : 0.f;
      at[BM + c] = row < S ? li[stat0 + row] : 1.f;
      at[2 * BM + c] = row < S ? Di[stat0 + row] : 0.f;
    }
  };

  tile_load<BN, D, NT>(sK, kg, sk.s, k0, S, tid);
  tile_load<BN, DV, NT>(sV, vg, sv.s, k0, S, tid);
  stage(0, 0);

  float dkacc[D / 8][4], dvacc[DV / 8][4];
  zero(dkacc);
  zero(dvacc);

  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      stage(t + 1, (t + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int st = t & 1, i0 = (qt0 + t % per_head) * BM;
    const bf16* sQt = sQ + st * BM * D;
    const bf16* sOt = sO + st * BM * DV;
    const float* sM = sStat + st * 3 * BM;
    float s[BM / 8][4], dp[BM / 8][4];
    zero(s);
    zero(dp);
    gemm_ss_nt<D, BM, D, D>(s, sK, r0, sQt, lane);
    gemm_ss_nt<DV, BM, DV, DV>(dp, sV, r0, sOt, lane);
    const bool mask = i0 < k0 + BN || i0 + BM > S;
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
        float x = bf16_round(s[nt][e]) * scale;
        if (mask) {
          const int key = key_lo + (e >> 1) * 8, qry = i0 + c;
          if (qry < key || qry >= S) x = kNegInf;
        }
        const float p = expf(x - sM[c]) / sM[BM + c];
        const float d = bf16_round(dp[nt][e]);
        s[nt][e] = p;
        dp[nt][e] = (p * (d - sM[2 * BM + c])) * scale;
      }
    uint32_t pf[BM / 16][4], sf[BM / 16][4];
    to_a_frags<BM>(pf, s);
    to_a_frags<BM>(sf, dp);
    gemm_rs_nn<BM, DV, DV>(dvacc, pf, sOt, lane);
    gemm_rs_nn<BM, D, D>(dkacc, sf, sQt, lane);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key_lo + 8 * i;
    if (row >= S) continue;
    bf16* krow = dk + ((long long)(b * S + row) * KV + kh) * D;
    bf16* vrow = dv + ((long long)(b * S + row) * KV + kh) * DV;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(krow + nt * 8 + 2 * (lane & 3)) =
          pack_bf16(dkacc[nt][2 * i], dkacc[nt][2 * i + 1]);
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt)
      *reinterpret_cast<uint32_t*>(vrow + nt * 8 + 2 * (lane & 3)) =
          pack_bf16(dvacc[nt][2 * i], dvacc[nt][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// launchers: tile sizes per head-dimension pair
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Opts `kern` into `bytes` of dynamic shared memory once per device (the
// attribute outlives the call; a later launch, inside a CUDA graph capture
// too, makes no such call). `done` is the kernel's own flags.
template <typename K>
cudaError_t smem_opt_in(K kern, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  Strides sq, sk, sv, sdo;
  bf16 *o, *dq, *dk, *dv;
  float *m, *l, *D;
  int B, S, H, KV;
  float scale;
  cudaStream_t stream;
};

template <int D, int DV>
cudaError_t launch_fwd(const Args& a) {
  constexpr int BM = kTile, BN = Tiles<D, DV>::fwd_bn;
  constexpr int smem = (BM * D + 2 * BN * D + 2 * BN * DV) * 2;
  static bool done[kMaxDevices] = {};
  auto kern = attn_fwd<D, DV, BM, BN>;
  cudaError_t e = smem_opt_in(kern, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.S + BM - 1) / BM);
  kern<<<grid, BM * 2, smem, a.stream>>>(a.q, a.k, a.v, a.sq, a.sk, a.sv, a.o,
                                         a.m, a.l, a.H, a.H / a.KV, a.S,
                                         a.scale);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_bwd(const Args& a) {
  {
    constexpr int BM = kTile, BN = Tiles<D, DV>::dq_bn;
    constexpr int smem = (BM * D + BM * DV + 2 * BN * D + 2 * BN * DV) * 2;
    static bool done[kMaxDevices] = {};
    auto kern = attn_bwd_dq<D, DV, BM, BN>;
    cudaError_t e = smem_opt_in(kern, smem, done);
    if (e != cudaSuccess) return e;
    dim3 grid(a.B * a.H, (a.S + BM - 1) / BM);
    kern<<<grid, BM * 2, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.sq, a.sk,
                                           a.sv, a.sdo, a.m, a.l, a.dq, a.D,
                                           a.H, a.H / a.KV, a.S, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  constexpr int BN = kTile, BM = Tiles<D, DV>::dkv_bm;
  constexpr int smem =
      (BN * D + BN * DV + 2 * BM * D + 2 * BM * DV) * 2 + 6 * BM * 4;
  static bool done[kMaxDevices] = {};
  auto kern = attn_bwd_dkdv<D, DV, BN, BM>;
  cudaError_t e = smem_opt_in(kern, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.KV, (a.S + BN - 1) / BN);
  kern<<<grid, BN * 2, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.sq, a.sk,
                                         a.sv, a.sdo, a.m, a.l, a.D, a.dk,
                                         a.dv, a.H, a.H / a.KV, a.S, a.scale);
  return cudaGetLastError();
}

template <bool Fwd>
cudaError_t dispatch(const Args& a, int D, int DV) {
  if (D == 64 && DV == 64) return Fwd ? launch_fwd<64, 64>(a) : launch_bwd<64, 64>(a);
  if (D == 128 && DV == 128)
    return Fwd ? launch_fwd<128, 128>(a) : launch_bwd<128, 128>(a);
  if (D == 192 && DV == 128)
    return Fwd ? launch_fwd<192, 128>(a) : launch_bwd<192, 128>(a);
  return cudaErrorInvalidValue;
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

extern "C" {

// 1 where (D, DV) is an instantiated pair of head dimensions.
int causal_attention_supports(int D, int DV) {
  return (D == 64 && DV == 64) || (D == 128 && DV == 128) ||
         (D == 192 && DV == 128);
}

// Forward on `stream`: o, and the row statistics m and l for the backward.
// `st` holds the (batch, position, head) strides of q, k and v in turn.
// Returns cudaGetLastError() after the launch (a launch refused for its
// shared memory or grid never runs, and only this reports it).
int causal_attention_fwd(const void* q, const void* k, const void* v,
                         const long long* st, void* o, void* m, void* l,
                         int B, int S, int H, int KV, int D, int DV,
                         float scale, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.sq = strides(st);
  a.sk = strides(st + 3);
  a.sv = strides(st + 6);
  a.o = static_cast<bf16*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B, a.S = S, a.H = H, a.KV = KV, a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<true>(a, D, DV));
}

// Backward on `stream`, two launches: dq and D (over query tiles), then dk
// and dv (over key tiles). `st` holds the strides of q, k, v and dO.
int causal_attention_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const long long* st,
                         const void* m, const void* l, void* dq, void* dk,
                         void* dv, void* Dbuf, int B, int S, int H, int KV,
                         int D, int DV, float scale, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.sq = strides(st);
  a.sk = strides(st + 3);
  a.sv = strides(st + 6);
  a.sdo = strides(st + 9);
  a.m = static_cast<float*>(const_cast<void*>(m));
  a.l = static_cast<float*>(const_cast<void*>(l));
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.D = static_cast<float*>(Dbuf);
  a.B = B, a.S = S, a.H = H, a.KV = KV, a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<false>(a, D, DV));
}

}  // extern "C"
