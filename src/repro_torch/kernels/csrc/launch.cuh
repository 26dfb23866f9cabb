// launch.cuh: what kernels B1 (fused_cosine.cu), B2 (ef_update.cu), B3
// (bitpack.cu), B5 (sign_quant.cu) and B6 (topk_mask.cu) share around their
// launches: programmatic dependent launch (PDL) on the device and on the
// host, and the device guard of their C entry points. Each source includes
// it into its own library.
#pragma once

#include <cuda_runtime.h>

namespace port {

// Every launch through launch_pdl sets programmatic stream serialization
// (Hopper's programmatic dependent launch): the grid may start while the
// previous kernel on its stream drains, and waits here, before its first
// global access, until that kernel's memory is visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches `kernel(args...)` as `blocks` blocks of `threads` on `stream`
// with programmatic stream serialization; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), unsigned blocks,
                       unsigned threads, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Runs `fn` (returning a cudaError_t) with `device` current, restoring the
// caller's device after; returns fn's error, or the device switch's.
template <typename Fn>
int on_device(int device, Fn fn) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = fn();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace port
