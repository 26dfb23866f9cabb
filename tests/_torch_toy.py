"""A toy compression method and codec for the port's registries — the
third-party extension that tests/test_torch_strategy_api.py registers in a
fixture and that tests/_torch_fanout.py registers in its ranks. It
imports no JAX, so the ranks can load it."""
import torch

from repro_torch.comm import CODECS, Codec, frame, register_codec
from repro_torch.comm.codec import array_to_bytes, bytes_to_array
from repro_torch.core import flat
from repro_torch.core import strategy as S

TOY_KIND = "toy_meansign"


class ToyMeanSign(S.CompressionStrategy):
    """Per-leaf mean-|x| scale times sign — a 10-line custom method."""

    def payload_floats(self, params):
        leaves = flat.tree_leaves(params)
        return sum(l.numel() for l in leaves) / 32.0 + len(leaves)

    def client_encode(self, key, u, params):
        recon = flat.tree_map(lambda l: torch.mean(torch.abs(l))
                              * torch.sign(l), u)
        return S.TreeCompressed(
            recon, torch.tensor(self.payload_floats(params)),
            torch.tensor(0.0), wire=recon)

    def server_decode(self, payload, params):
        return payload


class ToyCodec(Codec):
    """Trivial lossless codec: the recon tree as one raw f32 stream."""

    kind = TOY_KIND

    def _section_bytes(self):
        return (4 * self.d,)

    def _pack(self, wire):
        return [torch.cat([array_to_bytes(l)
                           for l in flat.tree_leaves(wire)])]

    def _unpack(self, sections):
        vec = bytes_to_array(sections[0], (self.d,))
        leaves, off = [], 0
        for shape, n in zip(self.shapes, self.sizes):
            leaves.append(vec[off:off + n].reshape(shape))
            off += n
        return self._leaf_tree(leaves)

    def canonical(self, wire):
        return flat.tree_map(lambda l: l.to(torch.float32), wire)


def register_toy() -> None:
    S.register_strategy(TOY_KIND)(ToyMeanSign)
    register_codec(ToyCodec)


def unregister_toy() -> None:
    del S.STRATEGIES[TOY_KIND], CODECS[TOY_KIND]
    del frame.KIND_NAMES[frame.KIND_IDS.pop(TOY_KIND)]
