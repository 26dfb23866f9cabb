"""B4 ssd_chunk — the Mamba2 SSD intra-chunk step.

Replaces the TPU kernel ``ssd_chunk_call`` of the JAX package
(``repro/kernels/ssd_chunk.py``). Per (batch, head, chunk) cell, with
``cs = cumsum(dA)``::

    L      = tril(exp(cs_i − cs_j))            (Q, Q) causal decay matrix
    y_diag = ((C·Bᵀ) ⊙ L) · xdt                (Q, P)
    state  = (xdt ⊙ exp(cs[-1] − cs))ᵀ · B     (P, N) end-of-chunk state
    decay  = exp(cs)                           (Q,)   incoming-state multiplier

The CUDA source is ``csrc/ssd_chunk.cu``: one block per (batch, chunk,
group of heads), C·Bᵀ formed once per block over its lower triangle, the
three products on the tensor cores as 3xTF32 (f32-class results), B, C
and each head's xdt staged with ``cp.async`` (see the source's note).

``ssd_chunk(xdt, dA, B, C)`` runs the plain PyTorch version for tensors on
the CPU and launches the kernel for tensors on a CUDA device; there is no
fallback from one to the other, and sizes or operands off a 16-byte
boundary, which the kernel does not take, raise. Fake CUDA tensors take
the meta branch (``kernels/meta.py``), after the sizes' check.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, meta

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# largest Q, N and P the kernel's tiles cover (``ssd_chunk_max_dim()``)
MAX_DIM = 128

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ssd_chunk")
        lib.ssd_chunk_max_dim.argtypes = []
        lib.ssd_chunk_max_dim.restype = ctypes.c_int
        lib.ssd_chunk_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.ssd_chunk_launch.restype = ctypes.c_int
        if lib.ssd_chunk_max_dim() != MAX_DIM:
            raise RuntimeError(f"ssd_chunk library takes dims up to "
                               f"{lib.ssd_chunk_max_dim()}, wrapper expects "
                               f"{MAX_DIM}")
        _LIB = lib
    return _LIB


def ssd_chunk_plain(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, batched over (b, h, nc): the JAX
    package's oracle (``kernels/ref.py::ssd_chunk``) cell by cell. The
    cumsum accumulates in f64 and rounds to f32, as the kernel's does (and
    as PyTorch's CPU cumsum of f32 does anyway): the same cs bits on every
    device and in every summation order."""
    Q = xdt.shape[-2]
    cs = torch.cumsum(dA.to(torch.float64), dim=-1).to(dA.dtype)  # (b,h,c,Q)
    diff = cs[..., :, None] - cs[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    L = torch.where(tril, torch.exp(diff), 0.0)
    scores = (C @ B.transpose(-1, -2))[:, None] * L               # (b,h,c,Q,Q)
    y = scores @ xdt
    decay_states = torch.exp(cs[..., -1:] - cs)
    state = (xdt * decay_states[..., None]).transpose(-1, -2) @ B[:, None]
    return y, state, torch.exp(cs)


def _check(xdt, dA, B, C) -> Tuple[int, int, int, int, int, int]:
    """(b, h, nc, Q, P, N) after checking types, shapes and layout."""
    for name, t in (("xdt", xdt), ("dA", dA), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk takes f32, got {name} {t.dtype}")
        if t.device != xdt.device:
            raise ValueError(f"operands on {xdt.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk takes contiguous operands ({name})")
    if xdt.dim() != 5:
        raise ValueError(f"xdt must be (b,h,nc,Q,P), got {tuple(xdt.shape)}")
    b, h, nc, Q, P = xdt.shape
    N = B.shape[-1]
    if (tuple(dA.shape) != (b, h, nc, Q) or tuple(B.shape) != (b, nc, Q, N)
            or tuple(C.shape) != (b, nc, Q, N)):
        raise ValueError(
            f"ssd_chunk shapes disagree: xdt {tuple(xdt.shape)}, dA "
            f"{tuple(dA.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    return b, h, nc, Q, P, N


def check_kernel_dims(Q: int, P: int, N: int) -> None:
    """Raises ``ValueError`` unless the kernel takes a (Q, P, N) cell: its
    tiles cover sizes up to ``MAX_DIM``, and it stages rows of P and N in
    16-byte loads."""
    if not (1 <= Q <= MAX_DIM and all(
            4 <= v <= MAX_DIM and v % 4 == 0 for v in (P, N))):
        raise ValueError(f"the ssd_chunk kernel takes 1 <= Q <= {MAX_DIM} "
                         f"and P, N multiples of 4 in [4, {MAX_DIM}], got "
                         f"Q={Q}, P={P}, N={N}")


def check_kernel_alignment(xdt: torch.Tensor, B: torch.Tensor,
                           C: torch.Tensor) -> None:
    """Raises ``ValueError`` unless xdt, B and C start on a 16-byte boundary
    (the kernel reads them in 16-byte loads)."""
    for name, t in (("xdt", xdt), ("B", B), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"the ssd_chunk kernel takes operands on a "
                             f"16-byte boundary; {name} starts at "
                             f"{t.data_ptr():#x}")


def ssd_chunk(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xdt (b,h,nc,Q,P); dA (b,h,nc,Q); B, C (b,nc,Q,N), contiguous f32.

    Returns (y_diag (b,h,nc,Q,P), states (b,h,nc,P,N), decay (b,h,nc,Q)).
    """
    global LAUNCHES
    b, h, nc, Q, P, N = _check(xdt, dA, B, C)
    if xdt.device.type == "cpu":
        return ssd_chunk_plain(xdt, dA, B, C)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda, not {xdt.device}")
    check_kernel_dims(Q, P, N)
    fake = meta.is_fake(xdt)
    if not fake:
        check_kernel_alignment(xdt, B, C)
    dev = xdt.device
    y = torch.empty((b, h, nc, Q, P), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, nc, P, N), dtype=torch.float32, device=dev)
    decay = torch.empty((b, h, nc, Q), dtype=torch.float32, device=dev)
    if b * h * nc == 0:
        return y, state, decay
    if fake:
        meta.launched("ssd_chunk", [xdt, dA, B, C], [y, state, decay])
        return y, state, decay
    lib = _lib()
    # the launcher uses the current device; this restores the caller's after
    with torch.cuda.device(dev):
        rc = lib.ssd_chunk_launch(
            xdt.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr(), decay.data_ptr(), b, h, nc, Q, P,
            N, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError {rc}")
    LAUNCHES += 1
    return y, state, decay
