// bitpack: the 32 -> 1 sign bit-packing kernel pair of the wire codec, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `pack_signs_2d` and `unpack_signs_2d`
// (src/repro/kernels/bitpack.py, `_pack_kernel` and `_unpack_kernel`), which
// stream (8, 4096) f32 tiles of one flat vector into (8, 128) uint32 tiles
// and back. Element i goes to word i / 32, bit i % 32 (LSB first); the bit is
// (x >= 0) after a subnormal is flushed to a zero of its sign (the reference
// computes with subnormals flushed: XLA's CPU runtime runs with FTZ/DAZ and a
// TPU has none), so -0.0 and -1e-40 pack to 1 and NaN to 0: one compare,
// x > -FLT_MIN, written out here rather than left to -ftz=true, which would
// change the other kernels' numerics through the shared flags. Bits past the
// stream's end are 1, as the reference pads the tail with +1.0.
//
// * pack (B3a) reads a tree's leaves where they lie and writes the sign bytes
//   straight into a frame's section: one launch takes a table of up to
//   kMaxSegs leaf segments (kernels/pack_table.py splits a longer tree on a
//   word boundary) by value (__grid_constant__). A warp packs a tile of 4
//   words (128 elements) at a time: lane l loads float4 number l of the
//   tile (the warp's load is 512 contiguous bytes), its four sign bits make
//   a nibble at bit 4 (l % 8) of word l / 8, three xor-shuffles OR the eight
//   nibbles of each word, and lane g < 4 stores word g. Where the tile lies
//   in one leaf at a 16-byte boundary the load is a float4; in one
//   unaligned leaf, four scalars; over more than one leaf (a word that
//   straddles two), four scalars, each lane walking the table forward. A
//   word's store is by bytes where the section is unaligned or ends inside
//   the word (the signSGD section ends 2 bytes into its last word, and the
//   scales follow). Trials on this card chose one float4 per lane per tile
//   and blocks of 256 threads: more float4s in flight per lane, or several
//   tiles loaded before any is packed, were slower at the MLP's n and no
//   faster at 4 Mi.
// * unpack (B3b) expands the sign sections of up to kMaxFrames frames, read
//   in place through a table of section pointers, into the rows of one
//   (rows, stride) f32 output: a warp expands a tile of 32 words of one row.
//   Lane l loads word l of the tile (by bytes where the section is unaligned
//   or ends inside the word, so nothing past the section is read); in step k
//   it takes word 4k + l / 8 by a shuffle and stores the float4 of its nibble
//   l % 8, number 32k + l of the tile: each store is 512 contiguous bytes.
//   The row stride is a multiple of 4, so every row starts on a 16-byte
//   boundary; the wrapper hides the padding. Blocks of 128 threads (256 were
//   slower at the MLP's n).
//
// Both launch with programmatic stream serialization (Hopper's programmatic
// dependent launch) and grids of at most one wave, as many blocks as the
// card holds at once (grid-stride loops over the tiles).
//
// Words are 32-bit; the wrapper keeps a flat call's words in an int32 tensor
// holding the same bits (torch's uint32 has partial operator support).
//
// Bound on an H100 SXM: no arithmetic to speak of, so bytes. pack reads 4n
// and writes n/8 bytes, unpack the reverse: 0.245 us each at the MLP's
// n = 199,210 and 3.35 TB/s, 5.165 us at 4 Mi + 5. At the MLP's n both are
// bound by the launch; the design makes a tree pack and a round's unpack one
// launch each, with no copy around them.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kPackThreads = 256;
constexpr int kUnpackThreads = 128;
constexpr int kPackTileWords = 4;
constexpr int kPackTileElems = 32 * kPackTileWords;
constexpr int kUnpackTileWords = 32;
constexpr int kMaxSegs = 64;
constexpr int kMaxFrames = 256;
constexpr unsigned kFull = 0xffffffffu;

struct PackSeg {
  const float* x;   // the leaf's element at `start`
  int64_t start;    // stream position
  int64_t n;
};
static_assert(sizeof(PackSeg) == 24, "B3a table entry");

struct PackTable {
  PackSeg seg[kMaxSegs];
  uint8_t* out;        // the stream's byte 0
  int64_t nbytes;      // the stream's bytes: no byte at or past it is written
  int64_t first_word;
  int64_t words;
  int64_t end;         // positions at or past `end` are padding (+1)
  int count;
};
static_assert(sizeof(PackTable) < 4096, "B3a table over 4 KB");

struct UnpackTable {
  const uint8_t* sec[kMaxFrames];  // each frame's sign section
  float* out;                      // row r at out + r * stride
  int64_t stride;                  // elements, a multiple of 4
  int64_t n;
  int64_t nbytes;                  // bytes of each section
  int count;
};
static_assert(sizeof(UnpackTable) < 4096, "B3b table over 4 KB");

// flush(x) >= 0: true for x >= 0 and for a negative subnormal (it flushes to
// -0.0), false for NaN
__device__ __forceinline__ uint32_t sign_bit(float v) {
  return v > -FLT_MIN ? 1u : 0u;
}

// The segment that holds stream position e: the last whose start <= e.
__device__ __forceinline__ int find_seg(const PackTable& t, int64_t e) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].start <= e) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// x[0..3], or +1 at and past `left`
__device__ __forceinline__ float4 load_scalar4(const float* x, int64_t left) {
  float4 v;
  v.x = left > 0 ? __ldg(x) : 1.f;
  v.y = left > 1 ? __ldg(x + 1) : 1.f;
  v.z = left > 2 ? __ldg(x + 2) : 1.f;
  v.w = left > 3 ? __ldg(x + 3) : 1.f;
  return v;
}

__device__ __forceinline__ void store_word(const PackTable& t, int64_t w,
                                           uint32_t word) {
  uint8_t* p = t.out + 4 * w;
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0 && 4 * w + 4 <= t.nbytes) {
    *reinterpret_cast<uint32_t*>(p) = word;
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * w + b < t.nbytes) p[b] = (uint8_t)(word >> (8 * b));
}

// Lane `lane`'s float4 of the tile at stream position e0: positions
// e0 + 4 lane .. + 3, +1 at and past e1.
__device__ __forceinline__ float4 load_tile(const PackTable& t, int64_t e0,
                                            int64_t e1, int lane) {
  const int s = find_seg(t, e0);
  const PackSeg& sg = t.seg[s];
  const int64_t e = e0 + 4 * lane;
  if (sg.start + sg.n >= e1) {
    const float* x = sg.x + (e - sg.start);
    if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && e + 4 <= e1)
      return __ldg(reinterpret_cast<const float4*>(x));
    return load_scalar4(x, e1 - e);
  }
  // the lane's positions rise with c: walk the table forward, reading an
  // entry only on stepping into it, so that no load waits for another
  int si = s;
  const float* x = sg.x;
  int64_t lo = sg.start, hi = sg.start + sg.n;
  float c4[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    c4[c] = 1.f;
    if (e + c < e1) {
      while (e + c >= hi) {
        ++si;
        x = t.seg[si].x;
        lo = t.seg[si].start;
        hi = lo + t.seg[si].n;
      }
      c4[c] = __ldg(x + (e + c - lo));
    }
  }
  return make_float4(c4[0], c4[1], c4[2], c4[3]);
}

__global__ void __launch_bounds__(kPackThreads)
pack_signs_table(const __grid_constant__ PackTable t) {
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (t.words + kPackTileWords - 1) / kPackTileWords;
  const int64_t warp =
      ((int64_t)blockIdx.x * kPackThreads + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * kPackThreads) >> 5;
  port::grid_dependency_wait();
  // the loop bound and the load path depend on the tile alone, so all 32
  // lanes reach every shuffle together
  for (int64_t tile = warp; tile < tiles; tile += nwarps) {
    const int64_t w0 = t.first_word + tile * kPackTileWords;
    const int64_t e0 = w0 * 32;
    const int64_t e1 =
        e0 + kPackTileElems < t.end ? e0 + kPackTileElems : t.end;
    const float4 v = load_tile(t, e0, e1, lane);
    // the nibble of positions 4 lane .. + 3 sits at bit 4 (lane % 8) of word
    // lane / 8; OR the eight nibbles of each word, and lane g takes word g
    uint32_t part = (sign_bit(v.x) | sign_bit(v.y) << 1 |
                     sign_bit(v.z) << 2 | sign_bit(v.w) << 3)
                    << (4 * (lane & 7));
    part |= __shfl_xor_sync(kFull, part, 1);
    part |= __shfl_xor_sync(kFull, part, 2);
    part |= __shfl_xor_sync(kFull, part, 4);
    const uint32_t word = __shfl_sync(kFull, part, 8 * (lane & 3));
    if (lane < kPackTileWords && w0 + lane < t.first_word + t.words)
      store_word(t, w0 + lane, word);
  }
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* sec, int64_t w,
                                              int64_t nbytes) {
  const int64_t b = 4 * w;
  if ((reinterpret_cast<uintptr_t>(sec) & 3) == 0 && b + 4 <= nbytes)
    return __ldg(reinterpret_cast<const uint32_t*>(sec) + w);
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (b + i < nbytes) word |= (uint32_t)__ldg(sec + b + i) << (8 * i);
  return word;
}

__device__ __forceinline__ float pm1(uint32_t nib, uint32_t bit) {
  return (nib & bit) ? 1.f : -1.f;
}

__global__ void __launch_bounds__(kUnpackThreads)
unpack_signs_frames(const __grid_constant__ UnpackTable t) {
  const int lane = threadIdx.x & 31;
  const int64_t nwords = (t.n + 31) >> 5;
  const int64_t row_tiles = (nwords + kUnpackTileWords - 1) / kUnpackTileWords;
  const int64_t tiles = row_tiles * t.count;
  const int64_t warp =
      ((int64_t)blockIdx.x * kUnpackThreads + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * kUnpackThreads) >> 5;
  port::grid_dependency_wait();
  for (int64_t tile = warp; tile < tiles; tile += nwarps) {
    const int64_t r = tile / row_tiles;
    const int64_t w0 = (tile - r * row_tiles) * kUnpackTileWords;
    const uint32_t word =
        w0 + lane < nwords ? load_word(t.sec[r], w0 + lane, t.nbytes) : 0u;
    float4* o = reinterpret_cast<float4*>(t.out + r * t.stride + w0 * 32);
    const int64_t left = t.n - w0 * 32;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t w = __shfl_sync(kFull, word, 4 * k + (lane >> 3));
      const uint32_t nib = w >> (4 * (lane & 7));
      const int q = 32 * k + lane;
      if (4 * q < left)
        o[q] = make_float4(pm1(nib, 1), pm1(nib, 2), pm1(nib, 4),
                           pm1(nib, 8));
    }
  }
}

// Blocks for `tiles` warp tiles: one warp each, at most as many blocks as
// the current device holds at once (one wave; a longer run loops). The
// wave is read once per kernel and device.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int threads, int64_t tiles,
                        int* blocks) {
  static int waves[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (waves[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return err;
    waves[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t want = (tiles + threads / 32 - 1) / (threads / 32);
  *blocks = (int)(want < waves[device] ? (want > 0 ? want : 1)
                                       : waves[device]);
  return cudaSuccess;
}

template <typename Table>
cudaError_t launch(void (*kernel)(Table), const Table& t, int threads,
                   int64_t tiles, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = wave_blocks(kernel, threads, tiles, &blocks);
  if (err != cudaSuccess) return err;
  return port::launch_pdl(kernel, (unsigned)blocks, (unsigned)threads,
                          stream, t);
}

}  // namespace

extern "C" {

int bitpack_max_segments() { return kMaxSegs; }
int bitpack_max_frames() { return kMaxFrames; }

// desc: `count` rows of (x, start, n) as int64 in stream order, contiguous
// (each row's start the previous row's start + n), n >= 1, the first at
// 32 * first_word; the launch packs words [first_word, first_word + words)
// of the stream at `out`, positions at or past `end` as +1, and writes no
// byte at or past `nbytes`. 1 <= count <= kMaxSegs, words >= 1. Launches on
// `stream` on `device` (the caller's current device is restored), with
// programmatic stream serialization, and returns the launch's error.
int pack_signs_launch(const int64_t* desc, int count, uint8_t* out,
                      int64_t nbytes, int64_t first_word, int64_t words,
                      int64_t end, int device, void* stream) {
  if (count < 1 || count > kMaxSegs || words < 1)
    return cudaErrorInvalidValue;
  PackTable t{};
  for (int k = 0; k < count; ++k) {
    t.seg[k].x = reinterpret_cast<const float*>(desc[3 * k]);
    t.seg[k].start = desc[3 * k + 1];
    t.seg[k].n = desc[3 * k + 2];
  }
  t.out = out;
  t.nbytes = nbytes;
  t.first_word = first_word;
  t.words = words;
  t.end = end;
  t.count = count;
  const int64_t tiles = (words + kPackTileWords - 1) / kPackTileWords;
  return port::on_device(device, [&] {
    return launch(pack_signs_table, t, kPackThreads, tiles,
                  reinterpret_cast<cudaStream_t>(stream));
  });
}

// secs: `count` pointers to sign sections of `nbytes` bytes each (>=
// ceil(n/8)), one per row; out: `count` rows of `stride` f32 (a multiple of 4,
// >= n, 16-byte aligned), of which the first n get +1 or -1. 1 <= count <=
// kMaxFrames, n >= 1. Launches as pack_signs_launch does.
int unpack_signs_launch(const int64_t* secs, int count, float* out,
                        int64_t stride, int64_t n, int64_t nbytes, int device,
                        void* stream) {
  if (count < 1 || count > kMaxFrames || n < 1 || (stride & 3) ||
      stride < n || nbytes < (n + 7) / 8 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  UnpackTable t{};
  for (int k = 0; k < count; ++k)
    t.sec[k] = reinterpret_cast<const uint8_t*>(secs[k]);
  t.out = out;
  t.stride = stride;
  t.n = n;
  t.nbytes = nbytes;
  t.count = count;
  const int64_t row_tiles =
      ((n + 31) / 32 + kUnpackTileWords - 1) / kUnpackTileWords;
  return port::on_device(device, [&] {
    return launch(unpack_signs_frames, t, kUnpackThreads, row_tiles * count,
                  reinterpret_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
