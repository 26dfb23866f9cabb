"""B3 bitpack — the 32→1 sign bit-packing kernel pair of the wire codec.

Replaces the TPU kernels ``pack_signs_2d`` and ``unpack_signs_2d`` of the
JAX package (``repro/kernels/bitpack.py``). The CUDA source is
``csrc/bitpack.cu``: ``pack_signs`` builds each 32-bit word with one warp
ballot, ``unpack_signs`` writes one ±1 per thread. Both are bound by bytes
(4n in and n/8 out, or the reverse).

Wire contract, shared with ``comm.codec``: flat element ``i`` lands in word
``i // 32``, bit ``i % 32`` (LSB first); the bit is ``x >= 0`` after a
subnormal is flushed to a zero of its sign (``kernels.ftz``, as the
reference flushes it), so ``-0.0`` and ``-1e-40`` pack to 1, NaN to 0, and
an exact zero unpacks to +1. Bits past ``n`` in
the last word are 1 (the reference pads the tail with +1.0). Words are kept
as ``int32`` tensors holding the 32 bits; ``.view(torch.uint8)`` gives
their little-endian bytes.

``pack_signs``/``unpack_signs`` run the plain PyTorch version for tensors
on the CPU and launch the kernel for tensors on a CUDA device; there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches, one
dict entry per kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ftz import flush_subnormal

# kernel launches since import (or since a caller reset them to 0)
LAUNCHES = {"pack_signs": 0, "unpack_signs": 0}

# grid cap for the grid-stride loops (132 SMs x 8 resident blocks)
MAX_BLOCKS = 1024

_LIB = None
_THREADS = 0


def _lib() -> ctypes.CDLL:
    global _LIB, _THREADS
    if _LIB is None:
        lib = _build.load("bitpack")
        lib.bitpack_threads.argtypes = []
        lib.bitpack_threads.restype = ctypes.c_int
        for fn in (lib.pack_signs_launch, lib.unpack_signs_launch):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _THREADS = lib.bitpack_threads()
        _LIB = lib
    return _LIB


def num_words(n: int) -> int:
    return -(-n // 32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def pack_signs_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: pad with +1.0, flush subnormals, test
    ``>= 0``, shift and sum each row of 32 in int64."""
    n = x.numel()
    pad = num_words(n) * 32 - n
    xp = torch.cat([x, x.new_ones(pad)]) if pad else x
    bits = (flush_subnormal(xp) >= 0).to(torch.int64).reshape(-1, 32)
    words = torch.sum(bits << _shifts(x.device), dim=1)
    return _to_int32_bits(words)


def unpack_signs_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """The plain PyTorch version: bit ``i % 32`` of word ``i // 32`` -> ±1."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, None] >> _shifts(words.device)) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)[:n]


def _check_device(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous operand")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def _launch(fn, src: torch.Tensor, dst: torch.Tensor, n: int,
            units: int) -> None:
    # one element or one word's lane per thread, at most MAX_BLOCKS (a
    # grid-stride loop covers the rest)
    blocks = max(1, min(-(-units // _THREADS), MAX_BLOCKS))
    # the launcher uses the current device; this restores the caller's after
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), dst.data_ptr(), n, blocks,
                torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitpack launch failed: cudaError {rc}")


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(n,) f32 -> (ceil(n/32),) int32 sign words; bit = (flush(x) >= 0)."""
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"pack_signs takes an (n,) f32 vector, got "
                        f"{x.dtype}{list(x.shape)}")
    _check_device("pack_signs", x)
    if x.device.type == "cpu":
        return pack_signs_plain(x)
    n = x.numel()
    words = torch.empty(num_words(n), dtype=torch.int32, device=x.device)
    if n == 0:
        return words
    lib = _lib()
    _launch(lib.pack_signs_launch, x, words, n, 32 * words.numel())
    LAUNCHES["pack_signs"] += 1
    return words


def unpack_signs(words: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(n/32),) int32 sign words -> (n,) f32 in {-1, +1}."""
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError(f"unpack_signs takes (w,) int32 words, got "
                        f"{words.dtype}{list(words.shape)}")
    if words.numel() != num_words(n):
        raise ValueError(f"{words.numel()} words cannot hold exactly n={n} "
                         f"signs (need {num_words(n)})")
    _check_device("unpack_signs", words)
    if words.device.type == "cpu":
        return unpack_signs_plain(words, n)
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    if n == 0:
        return out
    lib = _lib()
    _launch(lib.unpack_signs_launch, words, out, n, n)
    LAUNCHES["unpack_signs"] += 1
    return out
