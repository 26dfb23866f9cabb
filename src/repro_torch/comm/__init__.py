"""repro_torch.comm — the wire-format layer: framed bytes, not accounted
floats.

``frame``  — versioned fixed-layout header, byte for byte the JAX
             package's.
``codec``  — per-compressor encode/decode between payloads and uint8
             frames, registered per ``CompressorConfig.kind``
             (``register_codec``).
``channel``— ``Channel`` transport interface + in-process transport moving
             only encoded buffers, with byte counters.
"""
from repro_torch.comm.channel import Channel, InProcessChannel, LinkStats
from repro_torch.comm.codec import (CODECS, Codec, make_codec,
                                    register_codec, wire_bytes)
from repro_torch.comm.frame import (FrameError, FrameSpec, parse_header,
                                    register_kind_id)

__all__ = ["CODECS", "Channel", "Codec", "FrameError", "FrameSpec",
           "InProcessChannel", "LinkStats", "make_codec", "parse_header",
           "register_codec", "register_kind_id", "wire_bytes"]
