// bitpack: the 32 -> 1 sign bit-packing kernel pair of the wire codec, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `pack_signs_2d` and `unpack_signs_2d`
// (src/repro/kernels/bitpack.py, `_pack_kernel` and `_unpack_kernel`), which
// stream (8, 4096) f32 tiles into (8, 128) uint32 tiles and back. Here the
// vectors are flat:
//
// * pack: flat element i goes to word i / 32, bit i % 32 (LSB first); the
//   bit is (x >= 0) after a subnormal is flushed to a zero of its sign (the
//   reference computes with subnormals flushed: XLA's CPU runtime runs with
//   FTZ/DAZ and a TPU has none), so -0.0 and -1e-40 pack to 1 and NaN to 0.
//   The flush is written out here, not left to -ftz=true, which would change
//   the other kernels' numerics through the shared flags. Each warp builds one
//   word per 32 consecutive elements: lane l tests x[32w + l] and
//   __ballot_sync hands back the word directly, lane l as bit l. Lanes past
//   n vote 1, as the reference pads the tail with +1.0. A grid-stride loop
//   walks the words, one warp per word at a time.
// * unpack: one thread per output element, ((w >> (i & 31)) & 1) ? +1 : -1.
//
// Words are 32-bit; the wrapper keeps them in an int32 tensor holding the
// same bits (torch's uint32 has partial operator support).
//
// Bound on an H100 SXM: no arithmetic to speak of, so bytes. pack reads 4n
// and writes n/8 bytes, unpack the reverse: 0.25 us each at the MLP's
// n = 199,210 and 3.35 TB/s. At that size both are launch-bound; the design
// reads each input once, coalesced (a warp's 32 loads are one 128-byte line),
// and writes each output once.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

__global__ void __launch_bounds__(kThreads)
pack_signs_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                  int64_t n, int64_t nwords) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * kThreads) >> 5;
  // the loop bound depends on the warp alone, so all 32 lanes reach every
  // ballot together
  for (int64_t w = warp; w < nwords; w += nwarps) {
    const int64_t i = (w << 5) + lane;
    const bool bit = i < n ? (flush_subnormal(__ldg(x + i)) >= 0.f) : true;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) words[w] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_signs_kernel(const uint32_t* __restrict__ words,
                    float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint32_t w = __ldg(words + (i >> 5));
    out[i] = ((w >> (i & 31)) & 1u) ? 1.f : -1.f;
  }
}

}  // namespace

extern "C" {

int bitpack_threads() { return kThreads; }

// x: n f32; words: ceil(n/32) 32-bit words (n >= 1).
// Launches on `stream`, on the caller's current device, and returns
// cudaGetLastError().
int pack_signs_launch(const float* x, uint32_t* words, int64_t n,
                      int64_t blocks, void* stream) {
  const int64_t nwords = (n + 31) >> 5;
  pack_signs_kernel<<<(unsigned)blocks, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      x, words, n, nwords);
  return (int)cudaGetLastError();
}

// words: ceil(n/32) 32-bit words; out: n f32 in {-1, +1} (n >= 1).
int unpack_signs_launch(const uint32_t* words, float* out, int64_t n,
                        int64_t blocks, void* stream) {
  unpack_signs_kernel<<<(unsigned)blocks, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      words, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
