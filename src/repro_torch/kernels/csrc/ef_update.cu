// ef_update: the error-feedback residual e' = u - s*d over f32 vectors, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `ef_update_2d` (src/repro/kernels/ef_update.py,
// `_kernel`), which streams (rows, 1024) tiles of u and d and takes s as a
// (1, 1) block. Here one elementwise grid-stride pass reads u and d once and
// writes e' once, with float4 accesses where all three pointers are 16-byte
// aligned and a scalar tail otherwise. s stays on the device (a 1-element
// tensor): no host sync to read it.
//
// Each element is one fmaf(-s, d, u), rounded once; the plain PyTorch version
// rounds s*d and the difference separately, so the two may differ by one
// rounding of the result.
//
// Bound on an H100 SXM: no arithmetic to speak of, so bytes: 3*n*4 bytes at
// 3.35 TB/s (0.71 us at the MLP's n = 199,210). At that size the launch
// latency dominates; the design moves each byte once, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ef_update_kernel(const float* __restrict__ u, const float* __restrict__ d,
                 const float* __restrict__ s_ptr, float* __restrict__ out,
                 int64_t n, int vec) {
  const float s = __ldg(s_ptr);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* u4 = reinterpret_cast<const float4*>(u);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = __ldg(u4 + i);
      const float4 b = __ldg(d4 + i);
      float4 r;
      r.x = fmaf(-s, b.x, a.x);
      r.y = fmaf(-s, b.y, a.y);
      r.z = fmaf(-s, b.z, a.z);
      r.w = fmaf(-s, b.w, a.w);
      o4[i] = r;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    out[i] = fmaf(-s, __ldg(d + i), __ldg(u + i));
  }
}

}  // namespace

extern "C" {

int ef_update_threads() { return kThreads; }

// u, d, out: n f32 each (n >= 1); s: one f32 on the device.
// Launches on `stream`, on the caller's current device, and returns
// cudaGetLastError().
int ef_update_launch(const float* u, const float* d, const float* s,
                     float* out, int64_t n, int64_t blocks, void* stream) {
  const int vec = ((reinterpret_cast<uintptr_t>(u) |
                    reinterpret_cast<uintptr_t>(d) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  ef_update_kernel<<<(unsigned)blocks, kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      u, d, s, out, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
