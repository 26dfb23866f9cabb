"""Codec registry: each compressor's payload as actual serialized bytes.

The port of the JAX package's ``comm/codec.py``. Every codec turns the wire
payload a strategy emits (``TreeCompressed.wire``) into one contiguous
``uint8`` tensor — framed by ``comm.frame`` — and decodes it back
bit-exactly. Given the same payload, a frame here is byte for byte the
reference's:

* **identity** (FedAvg): the raw f32 leaf stream — 4d bytes.
* **topk** (DGC): per leaf, a f32 value stream (4k) plus the kept indices
  bit-packed at ``ceil(log2 n_leaf)`` bits each.
* **signsgd**: one bit per coordinate — the whole tree's sign stream
  packed 32→1 by kernel B3a straight from the leaves into the frame, and a
  round's frames unpacked by one B3b launch (``kernels.bitpack``) — plus
  one f32 scale per leaf: ``ceil(d/8)`` payload bytes. 1-bit semantics:
  bit = (x >= 0), so exact zeros decode to +scale (``client_view`` applies
  the same convention on the client so EF and the server stay
  consistent).
* **stc**: per leaf, 1 sign bit per kept entry + packed indices + one f32
  mu.
* **threesfc**: the ``(D_syn, s)`` synthetic payload under a dtype policy
  (fp32 lossless / fp16 / bf16), ``s`` always f32. The server-side
  ``recon_tree`` is Eq. 10's one backward on the decoded payload.

Decode round-trip contract: ``decode(encode(wire))`` equals the canonical
payload bit-exactly, where canonical means "after the policy cast".
``decode_batch`` (the reference's ``jax.vmap(codec.decode)``) gives a
round's N canonical payloads stacked on a leading client axis, bitwise the
frame-by-frame decodes stacked. Frames stay on the payload's device; words
and index streams are integer ops, so a frame built on the card equals the
one built on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import frame
from repro_torch.configs.base import CompressorConfig
from repro_torch.core.flat import tree_stack
from repro_torch.core.strategy import TreeCompressed, leaf_k, make_strategy
from repro_torch.core.threesfc import SynData, SynSpec
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.kernels import bitpack
from repro_torch.kernels.ftz import flush_subnormal

PyTree = Any

POLICY_DTYPES = {"fp32": torch.float32, "fp16": torch.float16,
                 "bf16": torch.bfloat16}
POLICY_ITEMBYTES = {"fp32": 4, "fp16": 2, "bf16": 2}


# ---------------------------------------------------------------------------
# byte/bit stream primitives
# ---------------------------------------------------------------------------


def array_to_bytes(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Flat little-endian byte view of ``x`` cast to ``dtype``."""
    v = x.to(dtype).reshape(-1)
    if v.numel() == 0:
        return torch.zeros((0,), dtype=torch.uint8, device=x.device)
    return v.contiguous().view(torch.uint8)


def bytes_to_array(b: torch.Tensor, shape: Tuple[int, ...],
                   dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``array_to_bytes``."""
    n = int(np.prod(shape)) if len(shape) else 1
    if n == 0:
        return torch.zeros(shape, dtype=dtype, device=b.device)
    item = torch.empty((), dtype=dtype).element_size()
    if b.storage_offset() % item or not b.is_contiguous():
        # a section may start at any byte of the frame; a wider view needs
        # an aligned start
        b = b.clone()
    return b.view(dtype).reshape(shape)


def index_width(n: int) -> int:
    """Bits per index into a size-``n`` leaf: ceil(log2 n), min 1."""
    return max(1, int(n - 1).bit_length())


def stream_bytes(count: int, width: int) -> int:
    return -(-count * width // 8)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def pack_uint_stream(vals: torch.Tensor, width: int) -> torch.Tensor:
    """(k,) unsigned ints below 2**width -> ceil(k*width/8) uint8,
    LSB-first within the stream. Computed in int64."""
    v = vals.to(torch.int64).reshape(-1)
    nbytes = stream_bytes(v.numel(), width)
    bits = ((v[:, None] >> _arange(width, v.device)) & 1).reshape(-1)
    pad = nbytes * 8 - bits.numel()
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    return torch.sum(bits.reshape(nbytes, 8) << _arange(8, v.device),
                     dim=1).to(torch.uint8)


def unpack_uint_stream(b: torch.Tensor, count: int,
                       width: int) -> torch.Tensor:
    """Inverse of ``pack_uint_stream`` -> (count,) int64."""
    bits = ((b.to(torch.int64)[:, None] >> _arange(8, b.device))
            & 1).reshape(-1)
    bits = bits[: count * width].reshape(count, width)
    return torch.sum(bits << _arange(width, b.device), dim=1)


def _as_frame(buf) -> torch.Tensor:
    """A frame as a uint8 tensor (numpy arrays are copied in)."""
    if isinstance(buf, torch.Tensor):
        return buf
    return torch.from_numpy(np.array(buf, np.uint8))


def _pm1(x: torch.Tensor) -> torch.Tensor:
    """The 1-bit wire sign: +1 where x >= 0, else -1 (never 0); a
    subnormal is flushed first, as the reference flushes it."""
    return torch.where(flush_subnormal(x) >= 0, 1.0, -1.0).to(torch.float32)


# ---------------------------------------------------------------------------
# codec protocol
# ---------------------------------------------------------------------------


class Codec:
    """Encode a strategy's wire payload into framed bytes and back.

    Subclasses fill ``_section_bytes`` (static layout), ``_pack`` (payload
    -> per-section uint8 tensors), ``_unpack`` (sections -> canonical
    payload) and, where the codec quantizes, ``canonical`` and
    ``client_view`` (the client-side dequantized reconstruction, so EF in
    codec mode uses exactly what the server will apply). A codec whose
    layout allows it builds its frame in place and decodes a round's
    frames as one batch by overriding ``encode``, ``decode``,
    ``decode_batch`` and ``recon_batch`` (``SignCodec``).
    """

    kind: str = ""

    def __init__(self, cfg: CompressorConfig, params: PyTree,
                 policy: str = "fp32", *, strategy=None):
        if policy not in POLICY_DTYPES:
            raise ValueError(f"unknown dtype policy {policy!r}")
        self.cfg = cfg
        self.policy = policy
        # server reconstruction (``recon_tree``) delegates to the strategy's
        # ``server_decode``: each method's decode lives once
        self.strategy = strategy if strategy is not None \
            else make_strategy(cfg)
        leaves, self.treedef = tree_flatten(params)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.sizes = [int(np.prod(s)) if len(s) else 1 for s in self.shapes]
        self.d = int(sum(self.sizes))
        # storage-free params stand-in for shape-only reconstruction
        self.template = tree_unflatten(
            self.treedef, [torch.empty(s, device="meta") for s in self.shapes])
        self.spec = frame.FrameSpec(self.kind, policy,
                                    tuple(self._section_bytes()))
        if leaves and leaves[0].device.type != "meta":
            # the static header goes to the params' device now: a frame
            # encoded inside a client's step then copies nothing from the
            # host (no sync on the card)
            frame._static_on(self.spec, leaves[0].device)

    # -- static layout -----------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self.spec.nbytes

    @property
    def header_bytes(self) -> int:
        return self.spec.header_bytes

    def _section_bytes(self):
        raise NotImplementedError

    # -- wire --------------------------------------------------------------
    def encode(self, wire, round_idx: int = 0,
               client_idx: int = 0) -> torch.Tensor:
        """wire payload -> (nbytes,) uint8 framed buffer on its device."""
        sections = self._pack(wire)
        for s, want in zip(sections, self.spec.section_bytes):
            if s.dtype != torch.uint8 or s.numel() != want:
                raise ValueError(f"{self.kind} section {s.dtype}"
                                 f"{list(s.shape)}, layout wants {want} B")
        device = sections[0].device if sections else None
        header = frame.encode_header(self.spec, round_idx, client_idx, device)
        return torch.cat([header, *sections]) if sections else header

    def decode(self, buf):
        """(nbytes,) uint8 tensor or numpy array -> canonical payload."""
        buf = _as_frame(buf)
        parts = [buf[o:o + n] for o, n in
                 zip(self.spec.section_offsets, self.spec.section_bytes)]
        return self._unpack(parts)

    def decode_batch(self, bufs):
        """A round's N frames (a sequence of (nbytes,) frames, or an (N,
        nbytes) array) -> their canonical payloads stacked on a leading
        client axis: the reference's ``jax.vmap(codec.decode)``. By default
        frame by frame, then stacked; a codec may decode them as one
        batch."""
        return tree_stack([self.decode(b) for b in bufs])

    def _pack(self, wire):
        raise NotImplementedError

    def _unpack(self, sections):
        raise NotImplementedError

    # -- reconstruction ----------------------------------------------------
    def canonical(self, wire):
        """What ``decode(encode(wire))`` must reproduce, bit for bit,
        computed without touching the byte stream."""
        return wire

    def recon_tree(self, canon, params: PyTree) -> PyTree:
        """Server-side reconstruction from the decoded payload (the
        strategy's ``server_decode``)."""
        return self.strategy.server_decode(canon, params)

    def recon_batch(self, bufs, params: PyTree) -> PyTree:
        """A round's N frames (as ``decode_batch`` takes them) -> the N
        server reconstructions stacked on a leading client axis: the
        reference's ``jax.vmap(codec.recon_tree)`` over the decoded frames.
        By default frame by frame (``decode``, then ``recon_tree``), then
        stacked."""
        return tree_stack([self.recon_tree(self.decode(b), params)
                           for b in bufs])

    def check_round_wire(self) -> None:
        """Raise if this codec cannot host the round's codec mode (client EF
        must match the server decode exactly)."""
        return None

    def client_view(self, out: TreeCompressed):
        """(recon, direction, scale) the client uses in codec mode: the
        strategy's own for lossless codecs."""
        return out.recon, out.direction, out.scale

    def _leaf_tree(self, leaves) -> PyTree:
        return tree_unflatten(self.treedef, leaves)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

CODECS: Dict[str, Callable[..., Codec]] = {}


def register_codec(cls):
    """Register a ``Codec`` subclass under its ``kind`` (duplicates
    rejected); a kind without a built-in id gets one in the frame's
    extension range."""
    if not cls.kind:
        raise ValueError(
            f"codec class {cls.__name__} must set a non-empty `kind`")
    if cls.kind in CODECS:
        raise ValueError(f"codec kind {cls.kind!r} already registered "
                         f"(by {CODECS[cls.kind].__name__})")
    frame.register_kind_id(cls.kind)
    CODECS[cls.kind] = cls
    return cls


@register_codec
class IdentityCodec(Codec):
    """FedAvg: the raw f32 leaf stream, 4d payload bytes."""

    kind = "identity"

    def _section_bytes(self):
        return (4 * self.d,)

    def _pack(self, wire):
        return [torch.cat([array_to_bytes(l) for l in tree_leaves(wire)])]

    def _unpack(self, sections):
        vec = bytes_to_array(sections[0], (self.d,))
        leaves, off = [], 0
        for shape, n in zip(self.shapes, self.sizes):
            leaves.append(vec[off:off + n].reshape(shape))
            off += n
        return self._leaf_tree(leaves)

    def canonical(self, wire):
        return tree_map(lambda l: l.to(torch.float32), wire)


@register_codec
class TopkCodec(Codec):
    """DGC: per leaf, f32 values + indices at ceil(log2 n_leaf) bits."""

    kind = "topk"

    def _layout(self):
        for n in self.sizes:
            yield n, leaf_k(n, self.cfg.keep_ratio), index_width(n)

    def _section_bytes(self):
        out = []
        for _, k, w in self._layout():
            out += [4 * k, stream_bytes(k, w)]
        return out

    def _pack(self, wire):
        sections = []
        for (vals, idx), (_, _, w) in zip(wire, self._layout()):
            sections.append(array_to_bytes(vals))
            sections.append(pack_uint_stream(idx, w))
        return sections

    def _unpack(self, sections):
        out = []
        for i, (_, k, w) in enumerate(self._layout()):
            vals = bytes_to_array(sections[2 * i], (k,))
            idx = unpack_uint_stream(sections[2 * i + 1], k, w)
            out.append((vals, idx))
        return tuple(out)


@register_codec
class SignCodec(Codec):
    """signSGD: one packed sign bit per coordinate + one f32 scale per leaf.

    The sign stream covers the concatenated tree (ceil(d/8) bytes, no
    per-leaf padding). ``encode`` builds the frame in one buffer: the
    header, the scales, then kernel B3a packs the leaves, read where they
    lie, into the sign section. ``decode_batch`` unpacks a round's N sign
    sections with one B3b launch, gathers the N scale vectors in one copy
    and scales each leaf over (N, n_leaf); ``decode`` is its N = 1 case,
    and ``recon_batch`` returns it as it is.
    """

    kind = "signsgd"

    def _section_bytes(self):
        return (bitpack.num_bytes(self.d), 4 * len(self.sizes))

    def encode(self, wire, round_idx: int = 0,
               client_idx: int = 0) -> torch.Tensor:
        u, scales = wire
        leaves = [l.reshape(-1).to(torch.float32) for l in tree_leaves(u)]
        scales = scales.reshape(-1).to(torch.float32).contiguous()
        sizes = [l.numel() for l in leaves]
        if sizes != self.sizes or scales.numel() != len(sizes):
            raise ValueError(f"signsgd payload of leaves {sizes} and "
                             f"{scales.numel()} scales; the layout wants "
                             f"leaves {self.sizes} and {len(self.sizes)} "
                             f"scales")
        signs_at, scales_at = self.spec.section_offsets
        buf = torch.empty(self.nbytes, dtype=torch.uint8,
                          device=leaves[0].device)
        frame.write_header(buf, self.spec, round_idx, client_idx)
        buf[scales_at:].copy_(scales.view(torch.uint8))
        bitpack.pack_signs_tree(leaves, buf[signs_at:scales_at])
        return buf

    def decode(self, buf):
        return tree_map(lambda l: l[0], self._decode_frames([_as_frame(buf)]))

    def decode_batch(self, bufs):
        return self._decode_frames([_as_frame(b) for b in bufs])

    def _decode_frames(self, frames):
        signs_at, scales_at = self.spec.section_offsets
        pm1 = bitpack.unpack_signs_frames(frames, signs_at, self.d)
        scales = torch.stack([f[scales_at:scales_at + 4 * len(self.sizes)]
                              for f in frames]).view(torch.float32)
        leaves, off = [], 0
        for i, (shape, n) in enumerate(zip(self.shapes, self.sizes)):
            leaves.append((scales[:, i:i + 1] * pm1[:, off:off + n])
                          .reshape(len(frames), *shape))
            off += n
        return self._leaf_tree(leaves)

    def recon_batch(self, bufs, params):
        # the decoded payload is the reconstruction
        # (``SignSGDStrategy.server_decode`` returns it as it is)
        return self.decode_batch(bufs)

    def canonical(self, wire):
        u, scales = wire
        leaves = [s * _pm1(l) for s, l in zip(scales, tree_leaves(u))]
        return self._leaf_tree(
            [l.reshape(sh) for l, sh in zip(leaves, self.shapes)])

    def client_view(self, out):
        return self.canonical(out.wire), None, None


@register_codec
class StcCodec(Codec):
    """STC: per leaf, 1 sign bit per kept entry + packed indices + f32 mu.

    Same 1-bit sign semantics as ``SignCodec``: a kept value that is
    exactly zero (only when a leaf has fewer than k nonzeros) decodes to
    +mu where the float path reconstructs 0.
    """

    kind = "stc"

    def _layout(self):
        for n in self.sizes:
            yield n, leaf_k(n, self.cfg.keep_ratio), index_width(n)

    def _section_bytes(self):
        out = []
        for _, k, w in self._layout():
            out += [stream_bytes(k, 1), stream_bytes(k, w), 4]
        return out

    def _pack(self, wire):
        sections = []
        for (sgn, idx, mu), (_, _, w) in zip(wire, self._layout()):
            sections.append(pack_uint_stream(flush_subnormal(sgn) >= 0, 1))
            sections.append(pack_uint_stream(idx, w))
            sections.append(array_to_bytes(mu))
        return sections

    def _unpack(self, sections):
        out = []
        for i, (_, k, w) in enumerate(self._layout()):
            bits = unpack_uint_stream(sections[3 * i], k, 1)
            pm1 = bits.to(torch.float32) * 2.0 - 1.0
            idx = unpack_uint_stream(sections[3 * i + 1], k, w)
            mu = bytes_to_array(sections[3 * i + 2], ())
            out.append((pm1, idx, mu))
        return tuple(out)

    def canonical(self, wire):
        return tuple((_pm1(sgn), idx, mu) for sgn, idx, mu in wire)

    def client_view(self, out):
        return self.recon_tree(self.canonical(out.wire),
                               self.template), None, None


@register_codec
class ThreesfcCodec(Codec):
    """3SFC: the (D_syn, s) payload under a dtype policy; s always f32.

    ``recon_tree`` is the paper's decoder (Eq. 10): one backward of the
    global model on the decoded synthetic batch, scaled by s.
    """

    kind = "threesfc"

    def __init__(self, cfg, params, policy="fp32", *, strategy):
        syn_spec: SynSpec = strategy.syn_spec
        self.syn_spec = syn_spec
        lead = syn_spec.label_lead or syn_spec.x_shape[:1]
        if syn_spec.label_rank:
            self.y_shape = (*lead, syn_spec.label_rank)
            self.v_shape = (syn_spec.label_rank, syn_spec.num_classes)
        else:
            self.y_shape = (*lead, syn_spec.num_classes)
            self.v_shape = (0, 0)
        super().__init__(cfg, params, policy, strategy=strategy)

    def _section_bytes(self):
        item = POLICY_ITEMBYTES[self.policy]
        sizes = [int(np.prod(s)) for s in
                 (self.syn_spec.x_shape, self.y_shape, self.v_shape)]
        return [item * n for n in sizes] + [4]

    def _pack(self, wire):
        syn, s = wire
        dt = POLICY_DTYPES[self.policy]
        return [array_to_bytes(syn.x, dt), array_to_bytes(syn.y, dt),
                array_to_bytes(syn.y_rank, dt), array_to_bytes(s)]

    def _unpack(self, sections):
        dt = POLICY_DTYPES[self.policy]
        x = bytes_to_array(sections[0], self.syn_spec.x_shape, dt)
        y = bytes_to_array(sections[1], self.y_shape, dt)
        v = bytes_to_array(sections[2], self.v_shape, dt)
        s = bytes_to_array(sections[3], ())
        return SynData(x.to(torch.float32), y.to(torch.float32),
                       v.to(torch.float32)), s

    def canonical(self, wire):
        syn, s = wire
        dt = POLICY_DTYPES[self.policy]
        return (SynData(*[a.to(dt).to(torch.float32) for a in syn]),
                s.to(torch.float32))

    def check_round_wire(self):
        if self.policy != "fp32":
            raise ValueError(
                "the round's wire mode requires the lossless fp32 policy "
                "for threesfc (client EF runs on the factored (gw, s)); "
                "lossy policies are a codec-level feature")

    def client_view(self, out):
        # EF runs on the factored (gw, s) — exact at the fp32 policy, the
        # only one the round's codec mode admits (check_round_wire)
        return None, out.direction, out.scale


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------


def make_codec(cfg: CompressorConfig, params: PyTree, *,
               syn_spec: Optional[SynSpec] = None,
               syn_loss_fn=None, policy: Optional[str] = None) -> Codec:
    """Build the registered codec for ``cfg.kind`` over a params template
    (only shapes are read). Raises ``KeyError`` for kinds without a wire
    format (randk, fedsynth: their budgets stay accounted-only)."""
    if cfg.kind not in CODECS:
        raise KeyError(
            f"no wire codec registered for compressor kind {cfg.kind!r} "
            f"(have: {sorted(CODECS)})")
    strategy = make_strategy(cfg, loss_fn=syn_loss_fn, syn_spec=syn_spec)
    return strategy.wire_codec(params, policy=policy)


def wire_bytes(cfg: CompressorConfig, params: PyTree, *,
               syn_spec: Optional[SynSpec] = None,
               policy: Optional[str] = None) -> int:
    """Static total frame size (header + payload) for one uplink message."""
    return make_codec(cfg, params, syn_spec=syn_spec, policy=policy).nbytes
