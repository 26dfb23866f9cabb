"""B6 topk_mask — DGC's threshold select over one flat f32 vector.

Replaces the TPU kernel ``topk_mask_2d`` of the JAX package
(``repro/kernels/topk_mask.py``) together with the floor its wrapper
``ops.topk_mask`` puts on τ. The CUDA source is ``csrc/topk_mask.cu``: one
launch of at most one wave of blocks (``kernels/one_wave.py``), each thread
taking one float4 per step, each warp counting with ballots, and each block
adding its count and a ticket to one 64-bit word of scratch in one atomic,
the block that draws the last ticket writing the total; bound by the 8n
bytes it moves.

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
of one element on x's device, read by the kernel on the device. n = 0
gives ``(empty, 0)`` without a launch; n must be below 2**40 (the count's
bits in the scratch word); an ``x`` off a 16-byte boundary is taken by the
kernel's scalar loads.

``topk_mask(x, tau)`` runs the plain PyTorch version for a tensor on the
CPU and launches the kernel for a tensor on a CUDA device; there is no
fallback from one to the other; a fake CUDA tensor takes the meta branch
(``kernels/meta.py``). ``LAUNCHES`` counts kernel launches. Each stream
gets its scratch at its first call, which must not be inside a
CUDA graph capture (it raises); later calls on that stream may be
captured and replayed.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, meta, one_wave
from repro_torch.kernels.ftz import flush_subnormal

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# the reference's floor on τ (``ops.topk_mask``), subnormal in f32
TAU_FLOOR = 1e-38

# threads per block of csrc/topk_mask.cu, one float4 per thread per step;
# the largest n whose count fits the scratch word's count bits
THREADS = 256
TILE = THREADS * 4
MAX_N = (1 << 40) - 1

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("topk_mask")
        lib.topk_mask_tile.argtypes = []
        lib.topk_mask_tile.restype = ctypes.c_int
        lib.topk_mask_wave.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.topk_mask_wave.restype = ctypes.c_int
        lib.topk_mask_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.topk_mask_launch.restype = ctypes.c_int
        if lib.topk_mask_tile() != TILE:
            raise RuntimeError(f"topk_mask.cu has a tile of "
                               f"{lib.topk_mask_tile()} elements, "
                               f"topk_mask.py {TILE}")
        _LIB = lib
    return _LIB


def wave(device_index: int) -> int:
    """Blocks of one wave of the kernel on that CUDA device."""
    got = ctypes.c_int(0)
    rc = _lib().topk_mask_wave(device_index, ctypes.byref(got))
    if rc != 0:
        raise RuntimeError(f"topk_mask wave query failed: cudaError {rc}")
    return got.value


# per (device index, stream): the ticket's word (after a wave of slots that
# B6 leaves unused, so that its plan is B5's)
_SCRATCH = one_wave.Scratch("topk_mask", wave)


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
    device, n = x.device, x.numel()
    if n == 0:
        return (torch.empty(0, dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))
    if n > MAX_N:
        raise ValueError(f"topk_mask counts at most {MAX_N} elements, got "
                         f"{n}")
    tau = tau.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=device)
    count = torch.empty((), dtype=torch.float32, device=device)
    if meta.is_fake(x):
        meta.launched("topk_mask", [x, tau], [out, count])
        return out, count
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    words = _SCRATCH.get(device, stream)
    wave = words.numel() - 1
    rc = _lib().topk_mask_launch(
        x.data_ptr(), tau.data_ptr(), out.data_ptr(),
        words.data_ptr() + 8 * wave, count.data_ptr(), n,
        one_wave.grid_blocks(n, TILE, wave), device.index, stream)
    if rc != 0:
        raise RuntimeError(f"topk_mask launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out, count
