"""B1 fused_cosine — (x·y, ‖x‖², ‖y‖²) over two flat f32 vectors, or over
two lists of leaves read where they lie.

Replaces the TPU kernel ``fused_cosine_2d`` of the JAX package
(``repro/kernels/fused_cosine.py``). The CUDA source is
``csrc/fused_cosine.cu``: one launch per table of up to ``TABLE`` leaves
(``kernels/leaf_table.py``), each block writing one ``(3,)`` row and the
last block to arrive summing the rows in block order, bound by the 2·n·4
bytes it reads.

``fused_cosine(x, y)`` (one vector pair, the one-segment table) and
``fused_cosine_leaves(xs, ys)`` run the plain PyTorch version for tensors
on the CPU and launch the kernel for tensors on a CUDA device; there is no
fallback from one to the other; fake CUDA tensors take the meta branch
(``kernels/meta.py``). ``LAUNCHES`` counts kernel launches, one per table.
Each stream gets its scratch at its first call, which must not
be inside a CUDA graph capture (it raises); later calls on that stream may
be captured and replayed.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import _build, leaf_table, meta

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# rows of partials a launch can need: TABLE segments of at most
# MAX_SEG_BLOCKS blocks (32,768 x 3 f32, 393 KB)
SCRATCH_ROWS = leaf_table.TABLE * leaf_table.MAX_SEG_BLOCKS

_LIB = None
# per (device index, stream): the (SCRATCH_ROWS, 3) partials scratch and the
# ticket counter, which each launch leaves at 0. Made once, at full size and
# outside any CUDA graph capture, so a captured launch keeps valid pointers
# and an eager launch never finds an unset ticket.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_cosine")
        for fn in (lib.fused_cosine_max_segments,
                   lib.fused_cosine_elems_per_block):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.fused_cosine_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.fused_cosine_launch.restype = ctypes.c_int
        got = (lib.fused_cosine_max_segments(),
               lib.fused_cosine_elems_per_block())
        want = (leaf_table.TABLE, leaf_table.ELEMS_PER_BLOCK)
        if got != want:
            raise RuntimeError(f"fused_cosine.cu has (table, elements per "
                               f"block) {got}, leaf_table.py {want}")
        _LIB = lib
    return _LIB


def fused_cosine_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: three f32 dot products."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    return torch.stack([torch.dot(xf, yf), torch.dot(xf, xf),
                        torch.dot(yf, yf)])


def fused_cosine_leaves_plain(xs: Sequence[torch.Tensor],
                              ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version over leaves: concatenate each operand, then
    ``fused_cosine_plain``."""
    return fused_cosine_plain(torch.cat(list(xs)), torch.cat(list(ys)))


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


def _check_leaves(xs: Sequence[torch.Tensor],
                  ys: Sequence[torch.Tensor]) -> torch.device:
    if len(xs) != len(ys):
        raise ValueError(f"fused_cosine_leaves takes two lists of one "
                         f"length, got {len(xs)} and {len(ys)}")
    if not xs:
        raise ValueError("fused_cosine_leaves takes at least one leaf")
    device = xs[0].device
    for x, y in zip(xs, ys):
        _check(x, y)
        if x.device != device:
            raise ValueError(f"leaves on {device} and {x.device}")
    return device


def _scratch(device: torch.device, stream: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    got = _SCRATCH.get(key)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_cosine: the first call on a stream is being captured "
                "into a CUDA graph; call it once on that stream before the "
                "capture, so that its scratch and ticket exist and are zero")
        got = (torch.empty((SCRATCH_ROWS, 3), dtype=torch.float32,
                           device=device),
               torch.zeros(1, dtype=torch.int32, device=device))
        _SCRATCH[key] = got
    return got


def _launch(xs: List[torch.Tensor], ys: List[torch.Tensor]) -> torch.Tensor:
    global LAUNCHES
    device = xs[0].device
    plan = leaf_table.segment_plan([x.numel() for x in xs])
    if not plan:                     # every leaf is empty
        return torch.zeros(3, dtype=torch.float32, device=device)
    out = torch.empty(3, dtype=torch.float32, device=device)
    if meta.is_fake(out):
        for step in plan:
            leaves = [leaf for leaf, _, _ in step.segments]
            meta.launched("fused_cosine", [xs[l] for l in leaves]
                          + [ys[l] for l in leaves], [out])
        return out
    lib = _lib()
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    partials, ticket = _scratch(device, stream)
    for j, step in enumerate(plan):
        desc = (ctypes.c_int64 * (5 * len(step.segments)))()
        for k, (leaf, first, blocks) in enumerate(step.segments):
            x, y = xs[leaf], ys[leaf]
            desc[5 * k:5 * k + 5] = (x.data_ptr(), y.data_ptr(), x.numel(),
                                     first, blocks)
        rc = lib.fused_cosine_launch(
            desc, len(step.segments), step.blocks, partials.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), int(j > 0), device.index,
            stream)
        if rc != 0:
            raise RuntimeError(f"fused_cosine launch failed: cudaError {rc}")
        LAUNCHES += 1
    return out


def _check_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"fused_cosine runs on cpu or cuda, not {device}")


def fused_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(3,) f32 = [x·y, ‖x‖², ‖y‖²] for (n,) f32 ``x``, ``y``."""
    _check(x, y)
    if x.device.type == "cpu":
        return fused_cosine_plain(x, y)
    _check_device(x.device)
    return _launch([x], [y])


def fused_cosine_leaves(xs: Sequence[torch.Tensor],
                        ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """(3,) f32 = [Σ x·y, Σ ‖x‖², Σ ‖y‖²] over paired contiguous f32 1-D
    leaves on one device, read where they lie: ``ceil(L / TABLE)`` launches
    for L non-empty leaves, each adding its triple to the previous one's in
    the kernel."""
    device = _check_leaves(xs, ys)
    if device.type == "cpu":
        return fused_cosine_leaves_plain(xs, ys)
    _check_device(device)
    return _launch(list(xs), list(ys))
