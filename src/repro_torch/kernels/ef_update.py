"""B2 ef_update — the error-feedback residual e' = u − s·d over flat f32
vectors, or over lists of leaves read and written where they lie.

Replaces the TPU kernel ``ef_update_2d`` of the JAX package
(``repro/kernels/ef_update.py``). The CUDA source is ``csrc/ef_update.cu``:
one elementwise launch per table of up to ``TABLE`` leaves
(``kernels/leaf_table.py``) that reads u and d once and writes e' once
(bound by 3·n·4 bytes), with ``s`` read on the device from a 1-element
tensor. Each element is one ``fmaf(-s, d, u)``, so a tree's result is
bitwise the flat kernel's on the concatenated operands.

``ef_update(u, d, s)`` (one vector, the one-segment table) and
``ef_update_leaves(us, ds, s)`` run the plain PyTorch version for tensors
on the CPU and launch the kernel for tensors on a CUDA device; there is no
fallback from one to the other; fake CUDA tensors take the meta branch
(``kernels/meta.py``). ``LAUNCHES`` counts kernel launches, one per table.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import _build, leaf_table, meta

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ef_update")
        for fn in (lib.ef_update_max_segments, lib.ef_update_elems_per_block):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.ef_update_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.ef_update_launch.restype = ctypes.c_int
        got = (lib.ef_update_max_segments(), lib.ef_update_elems_per_block())
        want = (leaf_table.TABLE, leaf_table.ELEMS_PER_BLOCK)
        if got != want:
            raise RuntimeError(f"ef_update.cu has (table, elements per "
                               f"block) {got}, leaf_table.py {want}")
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


def _check_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"ef_update runs on cpu or cuda, not {device}")


def _launch(us: List[torch.Tensor], ds: List[torch.Tensor], s: torch.Tensor,
            outs: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Into ``outs`` where given, else one output buffer for every leaf,
    each leaf's view starting on a 16-byte boundary (offsets rounded up to
    4 elements), so an aligned leaf keeps the kernel's float4 path."""
    global LAUNCHES
    device = us[0].device
    sizes = [u.numel() for u in us]
    if outs is None:
        padded = [-(-n // 4) * 4 for n in sizes]
        buf = torch.empty(sum(padded), dtype=torch.float32, device=device)
        outs = [o if p == n else o.narrow(0, 0, n) for o, p, n in
                zip(buf.split_with_sizes(padded), padded, sizes)]
    plan = leaf_table.segment_plan(sizes)
    if not plan:                     # every leaf is empty
        return outs
    if meta.is_fake(outs[0]):
        for step in plan:
            leaves = [leaf for leaf, _, _ in step.segments]
            meta.launched("ef_update", [us[l] for l in leaves]
                          + [ds[l] for l in leaves] + [s],
                          [outs[l] for l in leaves])
        return outs
    lib = _lib()
    s = s.reshape(1).contiguous()
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    for step in plan:
        desc = (ctypes.c_int64 * (6 * len(step.segments)))()
        for k, (leaf, first, blocks) in enumerate(step.segments):
            desc[6 * k:6 * k + 6] = (us[leaf].data_ptr(), ds[leaf].data_ptr(),
                                     outs[leaf].data_ptr(), sizes[leaf],
                                     first, blocks)
        rc = lib.ef_update_launch(desc, len(step.segments), step.blocks,
                                  s.data_ptr(), device.index, stream)
        if rc != 0:
            raise RuntimeError(f"ef_update launch failed: cudaError {rc}")
        LAUNCHES += 1
    return outs


def ef_update(u: torch.Tensor, d: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """(n,) f32 e' = u − s·d; ``s`` is a 1-element f32 tensor on u's
    device."""
    _check(u, d, s)
    if u.device.type == "cpu":
        return ef_update_plain(u, d, s)
    _check_device(u.device)
    return _launch([u], [d], s)[0]


def ef_update_leaves(us: Sequence[torch.Tensor], ds: Sequence[torch.Tensor],
                     s: torch.Tensor,
                     out: Optional[Sequence[torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
    """[u − s·d for each leaf pair] over paired contiguous f32 1-D leaves on
    one device, read where they lie: ``ceil(L / TABLE)`` launches for L
    non-empty leaves. On the card the outputs are views of one buffer, or
    ``out``'s leaves where given (each may be its ``u``: every element is
    read before it is written)."""
    if len(us) != len(ds):
        raise ValueError(f"ef_update_leaves takes two lists of one length, "
                         f"got {len(us)} and {len(ds)}")
    if not us:
        raise ValueError("ef_update_leaves takes at least one leaf")
    for u, d in zip(us, ds):
        _check(u, d, s)
        if u.device != us[0].device:
            raise ValueError(f"leaves on {us[0].device} and {u.device}")
    if out is not None:
        if len(out) != len(us):
            raise ValueError(f"out has {len(out)} leaves, u {len(us)}")
        for o, u in zip(out, us):
            _check(o, u, s)
    if us[0].device.type == "cpu":
        res = [ef_update_plain(u, d, s) for u, d in zip(us, ds)]
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return list(out)
    _check_device(us[0].device)
    return _launch(list(us), list(ds), s,
                   None if out is None else list(out))
