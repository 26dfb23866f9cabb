"""B6 topk_mask — DGC's threshold select over one flat f32 vector.

Replaces the TPU kernel ``topk_mask_2d`` of the JAX package
(``repro/kernels/topk_mask.py``) together with the floor its wrapper
``ops.topk_mask`` puts on τ. The CUDA source is ``csrc/topk_mask.cu``: one
pass writes the masked vector and one integer count per block, a second,
one-block pass sums the counts; bound by the 8n bytes it moves.

Contract: ``((n,) f32 x, τ) -> ((n,) f32 out, () f32 count)`` with

    keep  = |flush(x)| >= flush(max(τ, 1e-38))
    out   = keep ? x : 0          (a kept element keeps its own bits)
    count = Σ keep                (exact; as f32, equal to the reference's
                                   f32 count for n < 2**24)

where ``flush`` sends a subnormal to a zero of its sign (``kernels.ftz``),
as the reference computes: its 1e-38 floor is itself subnormal, so τ ≤
1e-38 keeps every element. The reference's kernel then also counts the
zeros of its tile padding; the port has no padding and counts the n real
elements, as the reference's ``ref.topk_mask`` does. τ is an f32 tensor
of one element on x's device, read by the kernel on the device. n = 0 gives ``(empty, 0)`` without a launch; operands off a 16-byte
boundary are taken by the kernel's scalar loop.

``topk_mask(x, tau)`` runs the plain PyTorch version for a tensor on the
CPU and launches the kernel for a tensor on a CUDA device; there is no
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

# first-pass grid cap, as B1's
MAX_BLOCKS = 1024

# the reference's floor on τ (``ops.topk_mask``), subnormal in f32
TAU_FLOOR = 1e-38

_LIB = None
_THREADS = 0


def _lib() -> ctypes.CDLL:
    global _LIB, _THREADS
    if _LIB is None:
        lib = _build.load("topk_mask")
        lib.topk_mask_threads.argtypes = []
        lib.topk_mask_threads.restype = ctypes.c_int
        lib.topk_mask_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.topk_mask_launch.restype = ctypes.c_int
        _THREADS = lib.topk_mask_threads()
        _LIB = lib
    return _LIB


def topk_mask_plain(x: torch.Tensor, tau: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the contract in the module docstring."""
    t = flush_subnormal(tau.reshape(()).clamp_min(TAU_FLOOR))
    keep = torch.abs(flush_subnormal(x)) >= t
    return (torch.where(keep, x, 0.0),
            torch.sum(keep, dtype=torch.int64).to(torch.float32))


def _check(x: torch.Tensor, tau: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"topk_mask takes an (n,) f32 vector, got "
                        f"{x.dtype}{list(x.shape)}")
    if tau.dtype != torch.float32 or tau.numel() != 1:
        raise TypeError(f"topk_mask takes one f32 threshold, got "
                        f"{tau.dtype}{list(tau.shape)}")
    if not x.is_contiguous():
        raise ValueError("topk_mask takes a contiguous operand")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_mask runs on cpu or cuda, not {x.device}")
    if tau.device != x.device:
        raise ValueError(f"x on {x.device}, threshold on {tau.device}")


def topk_mask(x: torch.Tensor, tau: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n,) f32 masked x, () f32 kept count) for an (n,) f32 ``x`` and a
    one-element f32 threshold ``tau`` on x's device."""
    global LAUNCHES
    _check(x, tau)
    if x.device.type == "cpu":
        return topk_mask_plain(x, tau)
    n = x.numel()
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.empty((), dtype=torch.float32, device=x.device)
    tau = tau.contiguous()
    lib = _lib()
    # first-pass grid: one float4 per thread, at most MAX_BLOCKS
    blocks = max(1, min(-(-n // (_THREADS * 4)), MAX_BLOCKS))
    partials = torch.empty(blocks, dtype=torch.int64, device=x.device)
    # the launcher uses the current device; this restores the caller's after
    with torch.cuda.device(x.device):
        rc = lib.topk_mask_launch(
            x.data_ptr(), tau.data_ptr(), out.data_ptr(), partials.data_ptr(),
            count.data_ptr(), n, blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"topk_mask launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out, count
