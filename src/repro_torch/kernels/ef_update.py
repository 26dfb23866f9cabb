"""B2 ef_update — the error-feedback residual e' = u − s·d over flat f32
vectors.

Replaces the TPU kernel ``ef_update_2d`` of the JAX package
(``repro/kernels/ef_update.py``). The CUDA source is ``csrc/ef_update.cu``:
one elementwise pass that reads u and d once and writes e' once (bound by
3·n·4 bytes), with ``s`` read on the device from a 1-element tensor.

``ef_update(u, d, s)`` runs the plain PyTorch version for tensors on the
CPU and launches the kernel for tensors on a CUDA device; there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# grid cap for the grid-stride loop (132 SMs x 8 resident blocks)
MAX_BLOCKS = 1024

_LIB = None
_THREADS = 0


def _lib() -> ctypes.CDLL:
    global _LIB, _THREADS
    if _LIB is None:
        lib = _build.load("ef_update")
        lib.ef_update_threads.argtypes = []
        lib.ef_update_threads.restype = ctypes.c_int
        lib.ef_update_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.ef_update_launch.restype = ctypes.c_int
        _THREADS = lib.ef_update_threads()
        _LIB = lib
    return _LIB


def ef_update_plain(u: torch.Tensor, d: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: u − s·d, rounding s·d and the difference
    separately."""
    return u - s.reshape(()) * d


def _check(u: torch.Tensor, d: torch.Tensor, s: torch.Tensor) -> None:
    for name, t in (("u", u), ("d", d), ("s", s)):
        if t.dtype != torch.float32:
            raise TypeError(f"ef_update takes f32, got {name}: {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"ef_update operands on {u.device} and "
                             f"{t.device}")
    if u.dim() != 1 or u.shape != d.shape:
        raise ValueError(f"ef_update takes two (n,) vectors, got "
                         f"{tuple(u.shape)} and {tuple(d.shape)}")
    if s.numel() != 1:
        raise ValueError(f"s must hold one element, got {tuple(s.shape)}")
    if not (u.is_contiguous() and d.is_contiguous()):
        raise ValueError("ef_update takes contiguous operands")


def ef_update(u: torch.Tensor, d: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """(n,) f32 e' = u − s·d; ``s`` is a 1-element f32 tensor on u's
    device."""
    global LAUNCHES
    _check(u, d, s)
    if u.device.type == "cpu":
        return ef_update_plain(u, d, s)
    if u.device.type != "cuda":
        raise ValueError(f"ef_update runs on cpu or cuda, not {u.device}")
    n = u.numel()
    out = torch.empty_like(u)
    if n == 0:
        return out
    lib = _lib()
    # one float4 per thread, at most MAX_BLOCKS (a grid-stride loop covers
    # the rest)
    blocks = max(1, min(-(-n // (_THREADS * 4)), MAX_BLOCKS))
    s = s.reshape(1).contiguous()
    # the launcher uses the current device; this restores the caller's after
    with torch.cuda.device(u.device):
        rc = lib.ef_update_launch(
            u.data_ptr(), d.data_ptr(), s.data_ptr(), out.data_ptr(), n,
            blocks, torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ef_update launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
