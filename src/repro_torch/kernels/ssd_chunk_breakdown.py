"""Where kernel B4 (``ssd_chunk``) spends its time, on a CUDA card.

There is no ncu on the card machine, so this script cuts the kernel
instead: it builds ``csrc/ssd_chunk.cu`` with ``-DSSD_CUT=1``, ``2`` and
``3`` (copies that return just before product (1), (2) and (3)) and as it
is, times each at the full mamba2-370m prefill shape with CUDA events, and
prints the differences (staging + cumsum, then each product) with each
build's registers and the whole kernel's SASS instruction counts. The cut
copies write partial outputs; only the whole kernel is checked against
the plain version. The builds go to ``build/ssd_chunk_breakdown/``.

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
PARTS = ((1, "staging + cumsum"), (2, "product (1) C.B^T"),
         (3, "product (2) S.xdt"), (0, "product (3) (xdt.w)^T.B"))
SASS_OPS = r"\b(LDS(?:\.\w+)*|LDG(?:\.\w+)*|STS|STG(?:\.\w+)*|FFMA|FMUL|BRA|MUFU\.\w+)\b"


def build_cuts(out_dir: str) -> dict:
    """One ``nvcc`` per SSD_CUT into ``out_dir``, all started together;
    {cut: (library path, ptxas register lines)}."""
    src = str(_build.CSRC / "ssd_chunk.cu")
    procs = {}
    for cut, _ in PARTS:
        lib = os.path.join(out_dir, f"libssd_cut{cut}.so")
        procs[cut] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DSSD_CUT={cut}",
             "-Xptxas", "-v", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for cut, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc -DSSD_CUT={cut}:\n{log}")
        out[cut] = (lib, [ln.split(":", 1)[-1].strip()
                          for ln in log.splitlines() if "registers" in ln])
    return out


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
              re.findall(SASS_OPS, sass)).items())))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
