"""B3 bitpack — the 32→1 sign bit-packing kernel pair of the wire codec.

Replaces the TPU kernels ``pack_signs_2d`` and ``unpack_signs_2d`` of the
JAX package (``repro/kernels/bitpack.py``). The CUDA source is
``csrc/bitpack.cu``: B3a packs a tree's leaves, read where they lie,
straight into a byte stream (a frame's sign section) in one launch per
table of leaves (``kernels/pack_table.py``); B3b expands the sign sections
of a batch of frames, read in place, into an ``(N, n)`` ±1 tensor in one
launch per ``MAX_FRAMES`` frames. Both are bound by bytes (4n in and n/8
out, or the reverse).

Wire contract, shared with ``comm.codec``: flat element ``i`` lands in word
``i // 32``, bit ``i % 32`` (LSB first), which is byte ``i // 8``, bit
``i % 8`` of the little-endian stream; the bit is ``x >= 0`` after a
subnormal is flushed to a zero of its sign (``kernels.ftz``, as the
reference flushes it), so ``-0.0`` and ``-1e-40`` pack to 1, NaN to 0, and
an exact zero unpacks to +1. Bits past ``n`` in the last word are 1 (the
reference pads the tail with +1.0). A flat call's words are kept as
``int32`` tensors holding the 32 bits; ``.view(torch.uint8)`` gives their
little-endian bytes.

The entries: ``pack_signs(x)`` and ``unpack_signs(words, n)`` (one flat
vector), ``pack_signs_tree(leaves, out)`` and ``unpack_signs_frames(frames,
offset, n)``. Each runs the plain PyTorch version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; there is no fallback
from one to the other, and fake CUDA tensors take the meta branch
(``kernels/meta.py``). ``LAUNCHES`` counts kernel launches, one dict entry
per kernel, whichever entry launched it.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Union

import torch

from repro_torch.kernels import _build, meta, pack_table
from repro_torch.kernels.ftz import flush_subnormal

# kernel launches since import (or since a caller reset them to 0)
LAUNCHES = {"pack_signs": 0, "unpack_signs": 0}

# frames per B3b launch: a table of section pointers, 2 KB of parameters
MAX_FRAMES = 256

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("bitpack")
        consts = (lib.bitpack_max_segments, lib.bitpack_max_frames)
        for fn in consts:
            fn.argtypes = []
            fn.restype = ctypes.c_int
        got = tuple(fn() for fn in consts)
        if got != (pack_table.TABLE, MAX_FRAMES):
            raise RuntimeError(f"bitpack.cu has (table, frames) {got}, the "
                               f"wrapper {(pack_table.TABLE, MAX_FRAMES)}")
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.pack_signs_launch.argtypes = [ptr, ctypes.c_int, ptr, i64, i64,
                                          i64, i64, ctypes.c_int, ptr]
        lib.unpack_signs_launch.argtypes = [ptr, ctypes.c_int, ptr, i64, i64,
                                            i64, ctypes.c_int, ptr]
        for fn in (lib.pack_signs_launch, lib.unpack_signs_launch):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def num_words(n: int) -> int:
    return -(-n // 32)


def num_bytes(n: int) -> int:
    """Bytes of a sign stream of ``n`` elements, with no padding word."""
    return -(-n // 8)


def _shifts(width: int, device) -> torch.Tensor:
    return torch.arange(width, dtype=torch.int64, device=device)


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def pack_signs_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: pad with +1.0, flush subnormals, test
    ``>= 0``, shift and sum each row of 32 in int64."""
    n = x.numel()
    pad = num_words(n) * 32 - n
    xp = torch.cat([x, x.new_ones(pad)]) if pad else x
    bits = (flush_subnormal(xp) >= 0).to(torch.int64).reshape(-1, 32)
    words = torch.sum(bits << _shifts(32, x.device), dim=1)
    return _to_int32_bits(words)


def unpack_signs_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """The plain PyTorch version: bit ``i % 32`` of word ``i // 32`` -> ±1."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, None] >> _shifts(32, words.device)) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)[:n]


def pack_signs_tree_plain(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version of the tree pack: the flat plain pack of the
    leaves' concatenation, as its first ``ceil(d/8)`` bytes."""
    flat = torch.cat([l.reshape(-1) for l in leaves])
    return pack_signs_plain(flat).view(torch.uint8)[:num_bytes(flat.numel())]


def unpack_signs_frames_plain(frames: Sequence[torch.Tensor], offset: int,
                              n: int) -> torch.Tensor:
    """The plain version of the frames' unpack: bit ``i % 8`` of byte
    ``offset + i // 8`` of each frame -> ±1, one row per frame."""
    nb = num_bytes(n)
    sec = torch.stack([f[offset:offset + nb] for f in frames])
    bits = (sec.to(torch.int64)[..., None] >> _shifts(8, sec.device)) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(len(frames),
                                                        -1)[:, :n]


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def _check_device(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous operand")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def _pack(leaves: List[torch.Tensor], out: torch.Tensor, nbytes: int) -> None:
    """B3a over ``leaves`` into the ``nbytes``-byte stream at ``out``: one
    launch per table of ``pack_table.pack_plan``."""
    sizes = [l.numel() for l in leaves]
    plan = pack_table.pack_plan(sizes)
    if not plan:                         # every leaf is empty
        return
    if meta.is_fake(out):
        for step in plan:
            first = 4 * step.first_word
            last = min(nbytes, 4 * (step.first_word + step.words))
            meta.launched(
                "pack_signs",
                [leaves[leaf].reshape(-1).narrow(0, start, n)
                 for leaf, start, _, n in step.segments],
                [out.narrow(0, first, last - first)])
        return
    lib = _lib()
    device = out.device
    end = sum(sizes)
    for step in plan:
        desc = (ctypes.c_int64 * (3 * len(step.segments)))()
        for k, (leaf, first, start, n) in enumerate(step.segments):
            desc[3 * k:3 * k + 3] = (leaves[leaf].data_ptr() + 4 * first,
                                     start, n)
        last = 32 * (step.first_word + step.words)
        rc = lib.pack_signs_launch(desc, len(step.segments), out.data_ptr(),
                                   nbytes, step.first_word, step.words,
                                   min(end, last), device.index,
                                   _stream(device))
        if rc != 0:
            raise RuntimeError(f"pack_signs launch failed: cudaError {rc}")
        LAUNCHES["pack_signs"] += 1


def _unpack(sections: List[torch.Tensor], n: int,
            device: torch.device) -> torch.Tensor:
    """B3b over the sign ``sections`` (uint8 views of one length, read in
    place) -> (N, n) f32, one launch per ``MAX_FRAMES`` rows. The rows lie
    ``stride`` (n rounded up to 4) elements apart, so each starts on a
    16-byte boundary; the caller gets the (N, n) view."""
    stride = -(-n // 4) * 4
    buf = torch.empty((len(sections), stride), dtype=torch.float32,
                      device=device)
    out = buf.narrow(1, 0, n)
    if meta.is_fake(buf):
        for r0 in range(0, len(sections), MAX_FRAMES):
            rows = sections[r0:r0 + MAX_FRAMES]
            meta.launched("unpack_signs", rows,
                          [out.narrow(0, r0, len(rows))])
        return out
    nbytes = sections[0].numel()
    lib = _lib()
    for r0 in range(0, len(sections), MAX_FRAMES):
        rows = sections[r0:r0 + MAX_FRAMES]
        secs = (ctypes.c_int64 * len(rows))(*[s.data_ptr() for s in rows])
        rc = lib.unpack_signs_launch(secs, len(rows), buf[r0].data_ptr(),
                                     stride, n, nbytes, device.index,
                                     _stream(device))
        if rc != 0:
            raise RuntimeError(f"unpack_signs launch failed: cudaError {rc}")
        LAUNCHES["unpack_signs"] += 1
    return out


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(n,) f32 -> (ceil(n/32),) int32 sign words; bit = (flush(x) >= 0)."""
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"pack_signs takes an (n,) f32 vector, got "
                        f"{x.dtype}{list(x.shape)}")
    _check_device("pack_signs", x)
    if x.device.type == "cpu":
        return pack_signs_plain(x)
    words = torch.empty(num_words(x.numel()), dtype=torch.int32,
                        device=x.device)
    _pack([x], words.view(torch.uint8), 4 * words.numel())
    return words


def pack_signs_tree(leaves: Sequence[torch.Tensor],
                    out: torch.Tensor) -> torch.Tensor:
    """Pack the signs of contiguous f32 ``leaves`` (any shapes, taken in
    order as one stream of d elements) into ``out``, a contiguous (ceil(d/8),)
    uint8 tensor on their device (a frame's sign section, at any byte),
    reading each leaf where it lies; returns ``out``. Bits past d in the
    last byte are 1."""
    if not leaves:
        raise ValueError("pack_signs_tree takes at least one leaf")
    if out.dtype != torch.uint8 or out.dim() != 1:
        raise TypeError(f"pack_signs_tree writes a (bytes,) uint8 stream, "
                        f"got {out.dtype}{list(out.shape)}")
    _check_device("pack_signs_tree", out)
    for l in leaves:
        if l.dtype != torch.float32:
            raise TypeError(f"pack_signs_tree takes f32 leaves, got "
                            f"{l.dtype}")
        if l.device != out.device:
            raise ValueError(f"pack_signs_tree: a leaf on {l.device}, the "
                             f"stream on {out.device}")
        _check_device("pack_signs_tree", l)
    d = sum(l.numel() for l in leaves)
    if out.numel() != num_bytes(d):
        raise ValueError(f"pack_signs_tree: {out.numel()} bytes cannot hold "
                         f"exactly d={d} signs (need {num_bytes(d)})")
    if out.device.type == "cpu":
        if d:
            out.copy_(pack_signs_tree_plain(leaves))
        return out
    _pack(list(leaves), out, out.numel())
    return out


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
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=words.device)
    return _unpack([words.view(torch.uint8)], n, words.device).select(0, 0)


def unpack_signs_frames(frames: Union[torch.Tensor, Sequence[torch.Tensor]],
                        offset: int, n: int) -> torch.Tensor:
    """The ±1 signs of N frames -> (N, n) f32: row r from the ``ceil(n/8)``
    bytes at byte ``offset`` of frame r (the sign section), read in place.
    ``frames`` is a sequence of contiguous 1-D uint8 tensors on one device,
    or a 2-D uint8 tensor whose rows are the frames; a frame may start at
    any byte. Nothing past a section is read."""
    rows = list(frames)
    if not rows:
        raise ValueError("unpack_signs_frames takes at least one frame")
    if offset < 0 or n < 0:
        raise ValueError(f"unpack_signs_frames: offset {offset} and n {n} "
                         f"must be >= 0")
    need = offset + num_bytes(n)
    for f in rows:
        if f.dtype != torch.uint8 or f.dim() != 1:
            raise TypeError(f"unpack_signs_frames takes (bytes,) uint8 "
                            f"frames, got {f.dtype}{list(f.shape)}")
        if f.device != rows[0].device:
            raise ValueError(f"frames on {rows[0].device} and {f.device}")
        if f.numel() < need:
            raise ValueError(f"a frame of {f.numel()} bytes has no "
                             f"{num_bytes(n)}-byte section at byte {offset}")
        _check_device("unpack_signs_frames", f)
    device = rows[0].device
    if device.type == "cpu":
        return unpack_signs_frames_plain(rows, offset, n)
    if n == 0:
        return torch.empty((len(rows), 0), dtype=torch.float32,
                           device=device)
    return _unpack([f.narrow(0, offset, num_bytes(n)) for f in rows], n,
                   device)
