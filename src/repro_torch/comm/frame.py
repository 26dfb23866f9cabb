"""Wire frame: a versioned fixed-layout header making every buffer
self-describing.

The port of the JAX package's ``comm/frame.py``; the layout is the same
byte for byte, so a frame written by either package parses in the other.
Every encoded uplink message is one contiguous ``uint8`` buffer::

    [ header (24 B) | section table (4 B x n_sections) | sections ... ]

The header layout (all multi-byte fields little-endian, the native order of
every host and card this package runs on):

    offset  size  field
    0       2     magic  b"3W"
    2       1     version (WIRE_VERSION)
    3       1     kind id        (KIND_IDS — CompressorConfig.kind)
    4       1     dtype policy id (POLICY_IDS — 3SFC payload dtype)
    5       1     n_sections
    6       2     reserved (0)
    8       4     round   (uint32)
    12      4     client  (uint32)
    16      4     payload bytes (sum of section lengths)
    20      4     reserved (0)

The layout is static per ``(CompressorConfig, params template)``: section
lengths live in the ``FrameSpec`` and are also written into the buffer so a
receiver without the config can still walk it. Only ``round`` and
``client`` change from message to message.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

MAGIC = b"3W"
WIRE_VERSION = 1
HEADER_BYTES = 24


class FrameError(ValueError):
    """A buffer that is not a valid wire frame: the base of every typed
    rejection ``parse_header`` raises, so a driver catches one class."""


class TruncatedFrameError(FrameError):
    """Buffer ends before the fixed header or its section table does."""


class BadMagicError(FrameError):
    """First two bytes are not the frame magic — not one of our frames."""


class BadVersionError(FrameError):
    """Unsupported wire version byte."""


class CorruptHeaderError(FrameError):
    """Header fields decode to nothing registered (kind/policy id)."""


class FrameSizeError(FrameError):
    """Internal sizes disagree: payload sum vs header, or buffer length
    vs the frame's self-description (e.g. truncated mid-payload)."""


# Stable on-the-wire ids; append only, never renumber.
KIND_IDS: Dict[str, int] = {
    "identity": 0, "topk": 1, "randk": 2, "signsgd": 3, "stc": 4,
    "threesfc": 5, "fedsynth": 6,
}
KIND_NAMES = {v: k for k, v in KIND_IDS.items()}

# Third-party codec kinds (comm.codec.register_codec) get ids in the
# extension range so they can never collide with a future built-in.
EXTENSION_KIND_BASE = 128


def _extension_id(kind: str) -> int:
    """Deterministic extension-range id from the kind name, so the same kind
    maps to the same on-the-wire byte in every process."""
    h = hashlib.sha256(kind.encode()).digest()
    return EXTENSION_KIND_BASE + h[0] % (256 - EXTENSION_KIND_BASE)


def register_kind_id(kind: str, kind_id: int = None) -> int:
    """Assign an on-the-wire id to a codec kind (idempotent for known ones).

    Without an explicit ``kind_id`` a name-derived extension-range id is
    used; a hash collision or an explicitly taken id is rejected. Ids must
    fit the 1-byte header field.
    """
    if kind in KIND_IDS:
        return KIND_IDS[kind]
    if kind_id is None:
        kind_id = _extension_id(kind)
    if not 0 <= kind_id <= 255:
        raise ValueError(f"kind id {kind_id} does not fit the 1-byte field")
    if kind_id in KIND_NAMES:
        raise ValueError(
            f"kind id {kind_id} for {kind!r} already taken by "
            f"{KIND_NAMES[kind_id]!r}; pass an explicit free kind_id")
    KIND_IDS[kind] = kind_id
    KIND_NAMES[kind_id] = kind
    return kind_id


# 3SFC payload dtype policies (see comm.codec.POLICY_DTYPES).
POLICY_IDS: Dict[str, int] = {"fp32": 0, "fp16": 1, "bf16": 2}
POLICY_NAMES = {v: k for k, v in POLICY_IDS.items()}


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Static layout of one message: everything but round/client."""

    kind: str
    policy: str
    section_bytes: Tuple[int, ...]

    @property
    def header_bytes(self) -> int:
        return HEADER_BYTES + 4 * len(self.section_bytes)

    @property
    def payload_bytes(self) -> int:
        return int(sum(self.section_bytes))

    @property
    def nbytes(self) -> int:
        return self.header_bytes + self.payload_bytes

    @property
    def section_offsets(self) -> Tuple[int, ...]:
        """Absolute byte offset of each section inside the buffer."""
        offs, o = [], self.header_bytes
        for n in self.section_bytes:
            offs.append(o)
            o += n
        return tuple(offs)


def _static_header(spec: FrameSpec) -> np.ndarray:
    """The constant part of header + section table (round/client zeroed)."""
    h = np.zeros(spec.header_bytes, np.uint8)
    h[0:2] = np.frombuffer(MAGIC, np.uint8)
    h[2] = WIRE_VERSION
    h[3] = KIND_IDS[spec.kind]
    h[4] = POLICY_IDS[spec.policy]
    h[5] = len(spec.section_bytes)
    h[16:20] = np.frombuffer(
        np.uint32(spec.payload_bytes).tobytes(), np.uint8)
    table = np.asarray(spec.section_bytes, np.uint32)
    h[HEADER_BYTES:] = np.frombuffer(table.tobytes(), np.uint8)
    return h


_ON_DEVICE: Dict[Tuple[FrameSpec, torch.device], torch.Tensor] = {}


def _static_on(spec: FrameSpec, device: torch.device) -> torch.Tensor:
    """The static header as a tensor on ``device``, copied there once
    (``Codec`` does that when it is built, outside any round)."""
    h = _ON_DEVICE.get((spec, device))
    if h is None:
        h = torch.from_numpy(_static_header(spec)).to(device)
        _ON_DEVICE[(spec, device)] = h
    return h


def _u32_as_i32(x: int) -> int:
    if not 0 <= x < 2 ** 32:
        raise ValueError(f"{x} does not fit the header's uint32 field")
    return x - 2 ** 32 if x >= 2 ** 31 else x


def encode_header(spec: FrameSpec, round_idx: int = 0, client_idx: int = 0,
                  device=None) -> torch.Tensor:
    """Full header + section table as a ``uint8`` tensor on ``device`` (the
    CPU by default), written by ``write_header``: a frame built on the card
    costs no host-to-device copy."""
    h = torch.empty(spec.header_bytes, dtype=torch.uint8,
                    device=torch.device(device or "cpu"))
    write_header(h, spec, round_idx, client_idx)
    return h


def write_header(out: torch.Tensor, spec: FrameSpec, round_idx: int = 0,
                 client_idx: int = 0) -> None:
    """Write the header and section table into the first
    ``spec.header_bytes`` of the ``uint8`` buffer ``out`` (whose byte 8
    lies on an 8-byte boundary), on its device: one copy of the static
    part, one fill of round and client as one little-endian int64."""
    # the int32 conversions check that both fit the header's uint32 fields
    lo = _u32_as_i32(int(round_idx)) & 0xFFFFFFFF
    hi = _u32_as_i32(int(client_idx))
    out[:spec.header_bytes].copy_(_static_on(spec, out.device))
    out[8:16].view(torch.int64).fill_(hi << 32 | lo)


def parse_header(buf) -> Dict:
    """Host-side: validate and read back a buffer's self-description.

    ``buf`` is a numpy array or a tensor (copied to the host). Every
    rejection is a typed ``FrameError`` subclass.
    """
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    b = np.asarray(buf, np.uint8)
    if b.ndim != 1 or b.size < HEADER_BYTES:
        raise TruncatedFrameError(f"frame too short: {b.shape}")
    if bytes(b[0:2].tobytes()) != MAGIC:
        raise BadMagicError(f"bad magic {b[:2]!r}")
    if int(b[2]) != WIRE_VERSION:
        raise BadVersionError(f"unsupported wire version {int(b[2])}")
    kind_id, policy_id = int(b[3]), int(b[4])
    if kind_id not in KIND_NAMES:
        raise CorruptHeaderError(f"unknown kind id {kind_id}")
    if policy_id not in POLICY_NAMES:
        raise CorruptHeaderError(f"unknown dtype policy id {policy_id}")
    n_sections = int(b[5])
    header_bytes = HEADER_BYTES + 4 * n_sections
    if b.size < header_bytes:
        raise TruncatedFrameError("frame shorter than its section table")

    def u32(o):
        return int(np.frombuffer(b[o:o + 4].tobytes(), np.uint32)[0])

    sections = tuple(u32(HEADER_BYTES + 4 * i) for i in range(n_sections))
    out = {
        "kind": KIND_NAMES[kind_id],
        "policy": POLICY_NAMES[policy_id],
        "round": u32(8),
        "client": u32(12),
        "payload_bytes": u32(16),
        "section_bytes": sections,
        "header_bytes": header_bytes,
        "nbytes": header_bytes + sum(sections),
    }
    if out["payload_bytes"] != sum(sections):
        raise FrameSizeError(
            f"payload size {out['payload_bytes']} != section sum "
            f"{sum(sections)}")
    if b.size != out["nbytes"]:
        raise FrameSizeError(
            f"buffer is {b.size} B, frame says {out['nbytes']} B")
    return out
