"""B7 causal_attention — causal grouped self-attention with an f32 softmax,
forward and backward, with the logits kept on chip.

Replaces no TPU kernel: the JAX package leaves attention to XLA, and the
port's ``models/attention.py`` ``_sdpa`` writes the same einsums out, which
on the card put every (H, S, S) logit through device memory in f32 several
times a call. The CUDA source is ``csrc/causal_attention.cu`` (its note
gives the design): a forward of two passes over the keys (the rows' max m
and sum l, then the normalised p and p·v) and a backward of two launches
(dq with D = Σ p·dP over query tiles; dk and dv over key tiles), all on the
tensor cores, every sum in a fixed order.

Contract: q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, DV), query head h
reading KV head h // G (G = H / KV), the mask causal; the result o (B, S,
H, DV) in v's dtype. The arithmetic is ``_sdpa``'s with ``causal_mask``,
rounding point for rounding point: logits = the product in the inputs'
dtype, cast to f32, times ``scale``, ``NEG_INF`` above the diagonal; the
softmax in f32, normalised before the cast to v's dtype; the backward's
D from the f32 probabilities, as softmax's backward takes it.

``causal_attention(q, k, v, scale)`` is differentiable once: its backward
raises under ``create_graph`` (a second derivative), as the B4 route's does
(``kernels/ops.py`` ``_SSDChunkedAD``). A second derivative (the 3SFC
and FedSynth encoders' objectives: their forwards and backwards, where the
remat runs each layer's forward again) runs inside ``second_order()``,
and ``models/attention.py`` keeps ``_sdpa`` there at any length. For
tensors on the CPU it runs the
plain PyTorch version of the same two-pass arithmetic
(``causal_attention_plain`` and ``causal_attention_plain_backward``); for
CUDA tensors it launches the kernels or raises: bf16 only, (D, DV) in
``PAIRS``, the last dimension contiguous, the other strides multiples of 8
and each operand on a 16-byte boundary. Fake CUDA tensors take the meta
branch (``kernels/meta.py``), each launch reported with its products'
FLOPs (``flops``). ``LAUNCHES`` counts kernel launches (one a forward, two
a backward).
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.kernels import _build, meta

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# the (q·k, v) head dimensions the kernels are instantiated for
PAIRS = ((64, 64), (128, 128), (192, 128))

# queries a forward block owns: the shortest sequence the route hands over
TILE = 64

# keys per step of the plain version's first pass, as the kernel's forward
BLOCK = 64

# the reference's finite mask value (``models.attention.NEG_INF``)
NEG_INF = -1e30

_LIB = None

# open ``second_order()`` scopes, process-wide: the autograd engine runs a
# CUDA backward, and the remat's forwards inside it, on a thread of its own
_SECOND_ORDER = 0


@contextlib.contextmanager
def second_order() -> Iterator[None]:
    """Within: a second derivative's forwards and backwards
    (``create_graph``), which the kernels do not take. The backwards
    belong inside too: the remat runs the forwards again there, and each
    must take the route its first run took."""
    global _SECOND_ORDER
    _SECOND_ORDER += 1
    try:
        yield
    finally:
        _SECOND_ORDER -= 1


def in_second_order() -> bool:
    """Whether a ``second_order()`` scope is open."""
    return _SECOND_ORDER > 0


def flops(B: int, S: int, H: int, D: int, DV: int) -> Dict[str, float]:
    """Each launch's product FLOPs over the causal half of the (S, S)
    logits: the forward q·k and p·v; the backward's dq launch q·k, dO·v and
    dS·k, its dk, dv launch dSᵀ·q and pᵀ·dO (the recomputed products
    counted once, in the dq launch; the forward's second q·k pass not at
    all)."""
    logits = B * H * S * (S + 1) / 2
    return {"attn_fwd": 2 * logits * (D + DV),
            "attn_bwd_dq": 2 * logits * (2 * D + DV),
            "attn_bwd_dkdv": 2 * logits * (D + DV)}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("causal_attention")
        lib.causal_attention_supports.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.causal_attention_supports.restype = ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.causal_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [strides] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        lib.causal_attention_fwd.restype = ctypes.c_int
        lib.causal_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 4 + [strides] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        lib.causal_attention_bwd.restype = ctypes.c_int
        for d, dv in PAIRS:
            if not lib.causal_attention_supports(d, dv):
                raise RuntimeError(f"causal_attention.cu lacks the head "
                                   f"dimensions ({d}, {dv})")
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _shapes(q, k, v) -> Tuple[int, int, int, int, int, int, int]:
    """(B, S, H, KV, G, D, DV) after checking the operands' shapes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"causal_attention takes (B, S, heads, dim) "
                         f"operands, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    KV, DV = k.shape[-2], v.shape[-1]
    if (tuple(k.shape) != (B, S, KV, D) or tuple(v.shape[:3]) != (B, S, KV)
            or KV == 0 or H % KV):
        raise ValueError(f"causal_attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    return B, S, H, KV, H // KV, D, DV


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, KV, G, S, S) f32 logits as ``_sdpa`` forms them, masked."""
    B, S, H, KV, G, D, _ = _shapes(q, k, k)
    s = torch.einsum("bqgrk,bsgk->bgrqs", q.reshape(B, S, KV, G, D),
                     k).to(torch.float32) * scale
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    return torch.where(causal, s, NEG_INF)


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The forward's two passes in plain PyTorch: (o (B, S, H, DV), m, l
    (B, H, S) f32). The first pass takes the rows' max and sum over blocks
    of ``BLOCK`` keys, rescaling the sum as the max grows, as the kernel
    does; the second the normalised p and p·v."""
    B, S, H, KV, G, D, DV = _shapes(q, k, v)
    s = _logits(q, k, scale)
    m = torch.full(s.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros(s.shape[:-1], device=q.device)
    for j in range(0, S, BLOCK):
        blk = s[..., j:j + BLOCK]
        mn = torch.maximum(m, blk.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(blk - mn[..., None]).sum(-1)
        m = mn
    p = torch.exp(s - m[..., None]) / l[..., None]
    o = torch.einsum("bgrqs,bsgk->bqgrk", p.to(v.dtype), v)
    return (o.reshape(B, S, H, DV), m.reshape(B, H, S), l.reshape(B, H, S))


def causal_attention_plain_backward(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, do: torch.Tensor,
                                    m: torch.Tensor, l: torch.Tensor,
                                    scale: float
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The backward in plain PyTorch from the forward's m and l: (dq, dk,
    dv) in the inputs' dtypes, with p recomputed as exp(s − m) / l, dP the
    product in v's dtype cast to f32, D = Σ p·dP and dS = p (dP − D) ·
    scale cast to the logits' dtype."""
    B, S, H, KV, G, D, DV = _shapes(q, k, v)
    s = _logits(q, k, scale)
    m, l = m.reshape(B, KV, G, S, 1), l.reshape(B, KV, G, S, 1)
    p = torch.exp(s - m) / l
    dog = do.reshape(B, S, KV, G, DV)
    dp = torch.einsum("bqgrk,bsgk->bgrqs", dog, v).to(torch.float32)
    Dsum = (p * dp).sum(-1, keepdim=True)
    ds = ((p * (dp - Dsum)) * scale).to(q.dtype)
    dq = torch.einsum("bgrqs,bsgk->bqgrk", ds, k).reshape(B, S, H, D)
    dk = torch.einsum("bgrqs,bqgrk->bsgk", ds, q.reshape(B, S, KV, G, D))
    dv = torch.einsum("bgrqs,bqgrk->bsgk", p.to(v.dtype), dog)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def check_kernel_operands(*ts: torch.Tensor) -> None:
    """Raises unless the kernels take these operands (q, k, v[, dO]): bf16,
    (D, DV) in ``PAIRS``, the last dimension contiguous, the other strides
    multiples of 8 elements and (real tensors) each on a 16-byte
    boundary."""
    q, k, v = ts[:3]
    for name, t in zip(("q", "k", "v", "dO"), ts):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the causal_attention kernel takes bf16, got "
                            f"{name} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"operands on {q.device} and {t.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"the causal_attention kernel takes a "
                             f"contiguous last dimension and strides in "
                             f"multiples of 8; {name} has {t.stride()}")
        if not meta.is_fake(t) and t.data_ptr() % 16:
            raise ValueError(f"the causal_attention kernel takes operands "
                             f"on a 16-byte boundary; {name} starts at "
                             f"{t.data_ptr():#x}")
    if (q.shape[-1], v.shape[-1]) not in PAIRS:
        raise ValueError(f"the causal_attention kernel takes (q·k, v) head "
                         f"dimensions in {PAIRS}, got "
                         f"({q.shape[-1]}, {v.shape[-1]})")


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def _forward(q, k, v, scale):
    global LAUNCHES
    B, S, H, KV, G, D, DV = _shapes(q, k, v)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention runs on cpu or cuda, not "
                         f"{q.device}")
    check_kernel_operands(q, k, v)
    dev = q.device
    o = torch.empty((B, S, H, DV), dtype=v.dtype, device=dev)
    m = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    if B * S * H == 0:
        return o, m, l
    if meta.is_fake(q):
        meta.launched("attn_fwd", [q, k, v], [o, m, l],
                      flops(B, S, H, D, DV)["attn_fwd"])
        return o, m, l
    with torch.cuda.device(dev):
        rc = _lib().causal_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), B, S, H, KV, D, DV,
            scale, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"causal_attention forward launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return o, m, l


def _backward(q, k, v, do, m, l, scale):
    global LAUNCHES
    B, S, H, KV, G, D, DV = _shapes(q, k, v)
    if q.device.type == "cpu":
        return causal_attention_plain_backward(q, k, v, do, m, l, scale)
    check_kernel_operands(q, k, v, do)
    dev = q.device
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, S, KV, D), dtype=k.dtype, device=dev)
    dv = torch.empty((B, S, KV, DV), dtype=v.dtype, device=dev)
    Dsum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    if B * S * H == 0:
        return dq, dk, dv
    if meta.is_fake(q):
        n = flops(B, S, H, D, DV)
        meta.launched("attn_bwd_dq", [q, k, v, do, m, l], [dq, Dsum],
                      n["attn_bwd_dq"])
        meta.launched("attn_bwd_dkdv", [q, k, v, do, m, l, Dsum], [dk, dv],
                      n["attn_bwd_dkdv"])
        return dq, dk, dv
    with torch.cuda.device(dev):
        rc = _lib().causal_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _strides(q, k, v, do), m.data_ptr(), l.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), Dsum.data_ptr(),
            B, S, H, KV, D, DV, scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"causal_attention backward launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 2
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    """Forward and backward through ``_forward`` and ``_backward``, saving
    q, k, v and the rows' m and l (no logits, no probabilities).

    Differentiable once: the backward raises when it runs under
    ``create_graph`` (the first half of a second derivative, as the 3SFC
    encoder takes it), where it would otherwise hand back gradients with no
    graph and so drop attention's second-order terms without a word.
    (``once_differentiable`` is not enough: autograd prunes its error node
    from a second backward to the layer's input.)"""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, m, l = _forward(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "causal_attention is differentiable once: a backward with "
                "create_graph=True (a second derivative, such as the 3SFC "
                "encoder's) cannot run through it; run its forward inside "
                "causal_attention.second_order(), which keeps "
                "attention._sdpa")
        q, k, v, m, l = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, do.contiguous(), m, l, ctx.scale)
        return dq, dk, dv, None


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Causal grouped self-attention, differentiable once: q (B, S, H, D),
    k (B, S, KV, D), v (B, S, KV, DV) -> (B, S, H, DV)."""
    return _CausalAttention.apply(q, k, v, scale)
