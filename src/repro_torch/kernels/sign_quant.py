"""B5 sign_quant — signSGD's int8 signs and mean |x| of one flat f32 vector.

Replaces the TPU kernel ``sign_quant_2d`` of the JAX package
(``repro/kernels/sign_quant.py``). The CUDA source is ``csrc/sign_quant.cu``:
one launch of at most one wave of blocks (``kernels/one_wave.py``), each
thread taking 8 elements per step (two float4 loads, one 8-byte store of
signs), each block leaving one partial of Σ|x| in a slot of scratch, and
the block that draws the last ticket summing the slots in block order and
writing Σ|x| / n on the device; bound by the 5n bytes it moves.

Contract: ``(n,) f32 -> ((n,) int8 signs, () f32 scale)``; the sign is
three-valued (0 for a zero, unlike B3's 1-bit sign) and both the sign and
|x| are taken after a subnormal is flushed to zero (``kernels.ftz``), as
the reference computes them. n = 0 gives ``(empty, NaN)`` (0/0, as the
reference) without a launch. An ``x`` off a 16-byte boundary is taken by
the kernel's scalar loads.

``sign_quant(x)`` runs the plain PyTorch version for a tensor on the CPU
and launches the kernel for a tensor on a CUDA device; there is no
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

# threads per block and elements per thread per step of csrc/sign_quant.cu
THREADS = 256
STEP = 8
TILE = THREADS * STEP

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("sign_quant")
        lib.sign_quant_tile.argtypes = []
        lib.sign_quant_tile.restype = ctypes.c_int
        lib.sign_quant_wave.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.sign_quant_wave.restype = ctypes.c_int
        lib.sign_quant_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.sign_quant_launch.restype = ctypes.c_int
        if lib.sign_quant_tile() != TILE:
            raise RuntimeError(f"sign_quant.cu has a tile of "
                               f"{lib.sign_quant_tile()} elements, "
                               f"sign_quant.py {TILE}")
        _LIB = lib
    return _LIB


def wave(device_index: int) -> int:
    """Blocks of one wave of the kernel on that CUDA device."""
    got = ctypes.c_int(0)
    rc = _lib().sign_quant_wave(device_index, ctypes.byref(got))
    if rc != 0:
        raise RuntimeError(f"sign_quant wave query failed: cudaError {rc}")
    return got.value


# per (device index, stream): a slot per block of a wave, the ticket's word
_SCRATCH = one_wave.Scratch("sign_quant", wave)


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
    device, n = x.device, x.numel()
    if n == 0:
        return (torch.empty(0, dtype=torch.int8, device=device),
                torch.full((), float("nan"), device=device))
    signs = torch.empty(n, dtype=torch.int8, device=device)
    scale = torch.empty((), dtype=torch.float32, device=device)
    if meta.is_fake(x):
        meta.launched("sign_quant", [x], [signs, scale])
        return signs, scale
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    words = _SCRATCH.get(device, stream)
    wave = words.numel() - 1
    slots = words.data_ptr()
    rc = _lib().sign_quant_launch(
        x.data_ptr(), signs.data_ptr(), slots, slots + 8 * wave,
        scale.data_ptr(), n, one_wave.grid_blocks(n, TILE, wave),
        device.index, stream)
    if rc != 0:
        raise RuntimeError(f"sign_quant launch failed: cudaError {rc}")
    LAUNCHES += 1
    return signs, scale
