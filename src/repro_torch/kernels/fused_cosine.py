"""B1 fused_cosine — (x·y, ‖x‖², ‖y‖²) over two flat f32 vectors.

Replaces the TPU kernel ``fused_cosine_2d`` of the JAX package
(``repro/kernels/fused_cosine.py``). The CUDA source is
``csrc/fused_cosine.cu``: a two-pass deterministic reduction (one
``(3,)`` row per block, then one block that sums the rows in a fixed
order), bound by the 2·n·4 bytes it reads.

``fused_cosine(x, y)`` runs the plain PyTorch version for tensors on the
CPU and launches the kernel for tensors on a CUDA device; there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# first-pass grid cap: 132 SMs x 8 resident 256-thread blocks, rounded down;
# the block count depends on n alone, which keeps the sum order fixed
MAX_BLOCKS = 1024

_LIB = None
_THREADS = 0


def _lib() -> ctypes.CDLL:
    global _LIB, _THREADS
    if _LIB is None:
        lib = _build.load("fused_cosine")
        lib.fused_cosine_threads.argtypes = []
        lib.fused_cosine_threads.restype = ctypes.c_int
        lib.fused_cosine_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.fused_cosine_launch.restype = ctypes.c_int
        _THREADS = lib.fused_cosine_threads()
        _LIB = lib
    return _LIB


def fused_cosine_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: three f32 dot products."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    return torch.stack([torch.dot(xf, yf), torch.dot(xf, xf),
                        torch.dot(yf, yf)])


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"fused_cosine takes f32, got {x.dtype}, {y.dtype}")
    if x.dim() != 1 or x.shape != y.shape:
        raise ValueError(f"fused_cosine takes two (n,) vectors, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("fused_cosine takes contiguous operands")


def fused_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(3,) f32 = [x·y, ‖x‖², ‖y‖²] for (n,) f32 ``x``, ``y``."""
    global LAUNCHES
    _check(x, y)
    if x.device.type == "cpu":
        return fused_cosine_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cosine runs on cpu or cuda, not {x.device}")
    n = x.numel()
    if n == 0:
        return torch.zeros(3, dtype=torch.float32, device=x.device)
    lib = _lib()
    # first-pass grid: one float4 per thread, at most MAX_BLOCKS
    blocks = max(1, min(-(-n // (_THREADS * 4)), MAX_BLOCKS))
    partials = torch.empty((blocks, 3), dtype=torch.float32, device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    # the launcher uses the current device; this restores the caller's after
    with torch.cuda.device(x.device):
        rc = lib.fused_cosine_launch(
            x.data_ptr(), y.data_ptr(), partials.data_ptr(), out.data_ptr(),
            n, blocks, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_cosine launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
