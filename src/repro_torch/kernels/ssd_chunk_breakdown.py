"""Where kernel B4 (``ssd_chunk``) spends its time, on a CUDA card.

There is no ncu on the card machine, so this script cuts the kernel
instead: it builds ``csrc/ssd_chunk.cu`` with ``-DSSD_CUT=1``, ``2`` and
``3`` (copies cut after the staging and cumsums of every head, after C·Bᵀ
once per head group, and after S·xdt over the heads) and as it is (the
state product over the heads added), times each at the full mamba2-370m
prefill shape with CUDA events, and prints the differences with each
build's registers and spills, and the whole kernel's SASS instruction
counts: ``HMMA`` shows the products on the tensor cores, ``LDGSTS`` the
``cp.async`` staging, ``FFMA`` what is left on the f32 pipe. The cut copies write partial outputs; only the
whole kernel is checked against the plain version. Last, it times a
kernel of nothing but ``mma.sync`` TF32 products (8 warps per SM, 8
independent tiles in each of 3 passes, as B4 issues them) and sets B4's
own count of ``mma.sync`` at the shape (from its tiling: the 3xTF32 split,
the diagonal tiles' upper halves and the edge padding included) against
that rate. The builds go to ``build/ssd_chunk_breakdown/``.

    PYTHONPATH=src python3 -m repro_torch.kernels.ssd_chunk_breakdown \
        [--shape b h nc Q P N]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_chunk as ssd_mod

# SSD_CUT of each build, and the part it adds to the one before, in order
PARTS = ((1, "staging + cumsum"), (2, "C.B^T once per head group"),
         (3, "S.xdt over the heads"), (0, "state (xdt.w)^T.B over the heads"))
SASS_OPS = (r"\b(HMMA(?:\.\w+)*|LDGSTS(?:\.\w+)*|LDGDEPBAR|DEPBAR(?:\.\w+)*"
            r"|LDS(?:\.\w+)*|LDG(?:\.\w+)*|STS(?:\.\w+)*|STG(?:\.\w+)*"
            r"|FFMA|FMUL|FADD|BAR(?:\.\w+)*|BRA|MUFU\.\w+)\b")


# a kernel of nothing but mma.sync m16n8k8 TF32 products: each warp runs
# `iters` rounds of 3 passes over 8 independent accumulators
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b[8][2];
  for (int e = 0; e < 4; ++e) a[e] = 0x3f800000u + (threadIdx.x + e) * 8192u;
  for (int n = 0; n < 8; ++n) { b[n][0] = a[n & 3]; b[n][1] = a[(n + 1) & 3]; }
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
              "+f"(acc[n][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[n][0]),
              "r"(b[n][1]));
  float s = 0.0f;
  for (int n = 0; n < 8; ++n)
    for (int e = 0; e < 4; ++e) s += acc[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int blocks, int iters,
                               void* stream) {
  mma_rate<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
MMA_RATE_ITERS = 2000
MMA_RATE_PER_WARP = 24        # mma.sync per round


def kernel_mmas(b, h, nc, Q, P, N, sms) -> int:
    """The mma.sync instructions B4 issues at this shape: its tiling in
    ``csrc/ssd_chunk.cu`` (groups of G heads per block, C·Bᵀ per block in
    16 x 32 units, S·xdt per warp over a short and a long row tile and
    half the column tiles, 4 at a time, the state in 32 x 32 units), each
    tile product three times (3xTF32)."""
    Qp, Np, Pp = -(-Q // 16) * 16, -(-N // 8) * 8, -(-P // 16) * 16
    G = 16
    while G > 1 and 10 * b * nc * (-(-h // G)) < 9 * sms:
        G //= 2
    ntq, npt = Qp // 16, Pp // 8
    cb = sum((i + 2) // 2 for i in range(ntq)) * 4 * (Np // 8)
    y = 0
    for warp in range(8):
        ra, rb = warp >> 1, ntq - 1 - (warp >> 1)
        if ra > rb:
            continue
        nper = (npt + 1) // 2
        first = (warp & 1) * nper
        chunks = -(-(min(first + nper, npt) - first) // 4)
        two = 2 * (ra + 1) if ra != rb else 0
        y += chunks * 4 * (2 * two + (2 * (rb + 1) - two))
    state = -(-(Pp // 16) // 2) * -(-(Np // 8) // 4) * 8 * (Qp // 8)
    return 3 * (b * nc * -(-h // G) * cb + b * h * nc * (y + state))


def ptxas_info(log: str) -> list:
    """The kernel's registers and spills from ``-Xptxas -v``."""
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build_cuts(out_dir: str) -> dict:
    """One ``nvcc`` per SSD_CUT into ``out_dir``, all started together;
    {cut: (library path, ptxas register lines)}, and the mma.sync rate
    kernel's library under "mma_rate"."""
    src = str(_build.CSRC / "ssd_chunk.cu")
    procs = {}
    for cut, _ in PARTS:
        lib = os.path.join(out_dir, f"libssd_cut{cut}.so")
        procs[cut] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DSSD_CUT={cut}",
             "-Xptxas", "-v", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    rate_src = os.path.join(out_dir, "mma_rate.cu")
    with open(rate_src, "w") as f:
        f.write(MMA_RATE_SRC)
    procs["mma_rate"] = (os.path.join(out_dir, "libmma_rate.so"),
                         subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, "libmma_rate.so"), rate_src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for cut, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc -DSSD_CUT={cut}:\n{log}")
        out[cut] = (lib, ptxas_info(log))
    return out


def kernel_sass(sass: str) -> str:
    """The SASS of ``ssd_chunk_kernel`` alone."""
    for part in sass.split("Function : ")[1:]:
        if "ssd_chunk_kernel" in part.split("\n", 1)[0]:
            return part
    raise RuntimeError("no ssd_chunk_kernel in the library's SASS")


def launcher(lib_path: str):
    fn = ctypes.CDLL(lib_path).ssd_chunk_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def time_ms(run, reps: int = 10, trials: int = 15) -> float:
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=6,
                    default=(4, 32, 16, 128, 64, 128),
                    metavar=("b", "h", "nc", "Q", "P", "N"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ssd_chunk_breakdown needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    b, h, nc, Q, P, N = args.shape
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    xdt = 0.1 * torch.randn((b, h, nc, Q, P), generator=g, device=dev)
    dA = -0.2 * torch.nn.functional.softplus(
        torch.randn((b, h, nc, Q), generator=g, device=dev))
    B = 0.5 * torch.randn((b, nc, Q, N), generator=g, device=dev)
    C = 0.5 * torch.randn((b, nc, Q, N), generator=g, device=dev)
    y = torch.empty_like(xdt)
    state = torch.empty((b, h, nc, P, N), device=dev)
    decay = torch.empty_like(dA)
    out_dir = _build.BUILD_DIR.parent / "ssd_chunk_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_cuts(str(out_dir))
    prev = 0.0
    for cut, label in PARTS:
        lib, info = libs[cut]
        fn = launcher(lib)

        def run(fn=fn):
            rc = fn(xdt.data_ptr(), dA.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), state.data_ptr(),
                    decay.data_ptr(), b, h, nc, Q, P, N,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        ms = time_ms(run)
        print(f"  up to {label}: {ms:.4f} ms (this part {ms - prev:.4f} "
              f"ms); {'; '.join(info)}")
        prev = ms
    want = ssd_mod.ssd_chunk_plain(xdt, dA, B, C)
    torch.cuda.synchronize()
    ok = all(torch.allclose(a, w, rtol=1e-4, atol=1e-5)
             for a, w in zip((y, state, decay), want))
    print(f"  whole kernel at (b,h,nc,Q,P,N)={tuple(args.shape)}: "
          f"{prev:.4f} ms, agrees with the plain version: {ok}")
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", libs[0][0]],
                          capture_output=True, text=True).stdout
    print("  SASS instructions of the whole kernel:",
          dict(sorted(collections.Counter(
              re.findall(SASS_OPS, kernel_sass(sass))).items())))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = ctypes.CDLL(libs["mma_rate"][0]).mma_rate_launch
    rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
    rate.restype = ctypes.c_int
    sink = torch.empty(sms * 256, device=dev)
    rate_ms = time_ms(lambda: rate(sink.data_ptr(), sms, MMA_RATE_ITERS,
                                   torch.cuda.current_stream().cuda_stream),
                      reps=3, trials=5)
    per_s = sms * 8 * MMA_RATE_ITERS * MMA_RATE_PER_WARP / (rate_ms * 1e-3)
    mmas = kernel_mmas(b, h, nc, Q, P, N, sms)
    print(f"  mma.sync m16n8k8 TF32 alone, 8 warps per SM: {per_s:.4e} per "
          f"s ({per_s * 2048 / 1e12:.1f} TFLOP/s); B4 issues {mmas} "
          f"({mmas * 2048 / 1e9:.3f} GFLOP of TF32 products), which at "
          f"that rate take {mmas / per_s * 1e3:.4f} ms: "
          f"{mmas / per_s * 1e3 / prev:.3f} of the whole kernel's time")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
