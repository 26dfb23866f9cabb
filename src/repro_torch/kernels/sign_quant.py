"""B5 sign_quant — signSGD's int8 signs and mean |x| of one flat f32 vector.

Replaces the TPU kernel ``sign_quant_2d`` of the JAX package
(``repro/kernels/sign_quant.py``). The CUDA source is ``csrc/sign_quant.cu``:
one pass writes the signs and leaves one partial of Σ|x| per block, a
second, one-block pass sums the partials in a fixed order and writes
Σ|x| / n on the device; bound by the 5n bytes it moves.

Contract: ``(n,) f32 -> ((n,) int8 signs, () f32 scale)``; the sign is
three-valued (0 for a zero, unlike B3's 1-bit sign) and both the sign and
|x| are taken after a subnormal is flushed to zero (``kernels.ftz``), as
the reference computes them. n = 0 gives ``(empty, NaN)`` (0/0, as the
reference) without a launch. An ``x`` off a 16-byte boundary is taken by
the kernel's scalar loop.

``sign_quant(x)`` runs the plain PyTorch version for a tensor on the CPU
and launches the kernel for a tensor on a CUDA device; there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ftz import flush_subnormal

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# first-pass grid cap, as B1's: the block count depends on n alone, which
# keeps the sum order fixed
MAX_BLOCKS = 1024

_LIB = None
_THREADS = 0


def _lib() -> ctypes.CDLL:
    global _LIB, _THREADS
    if _LIB is None:
        lib = _build.load("sign_quant")
        lib.sign_quant_threads.argtypes = []
        lib.sign_quant_threads.restype = ctypes.c_int
        lib.sign_quant_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.sign_quant_launch.restype = ctypes.c_int
        _THREADS = lib.sign_quant_threads()
        _LIB = lib
    return _LIB


def sign_quant_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: flush, three-valued sign, f32 mean of |x|."""
    f = flush_subnormal(x)
    signs = (f > 0).to(torch.int8) - (f < 0).to(torch.int8)
    return signs, torch.sum(torch.abs(f)) / x.numel()


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"sign_quant takes an (n,) f32 vector, got "
                        f"{x.dtype}{list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("sign_quant takes a contiguous operand")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sign_quant runs on cpu or cuda, not {x.device}")


def sign_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n,) int8 signs, () f32 Σ|x|/n) for an (n,) f32 ``x``."""
    global LAUNCHES
    _check(x)
    if x.device.type == "cpu":
        return sign_quant_plain(x)
    n = x.numel()
    signs = torch.empty(n, dtype=torch.int8, device=x.device)
    if n == 0:
        return signs, torch.full((), float("nan"), device=x.device)
    lib = _lib()
    # first-pass grid: one float4 per thread, at most MAX_BLOCKS
    blocks = max(1, min(-(-n // (_THREADS * 4)), MAX_BLOCKS))
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    # the launcher uses the current device; this restores the caller's after
    with torch.cuda.device(x.device):
        rc = lib.sign_quant_launch(
            x.data_ptr(), signs.data_ptr(), partials.data_ptr(),
            scale.data_ptr(), n, blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sign_quant launch failed: cudaError {rc}")
    LAUNCHES += 1
    return signs, scale
