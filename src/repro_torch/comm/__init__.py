"""repro_torch.comm — the wire-format layer: framed bytes, not accounted
floats.

``frame``  — versioned fixed-layout header, byte for byte the JAX
             package's.
``codec``  — per-compressor encode/decode between payloads and uint8
             frames, registered per ``CompressorConfig.kind``
             (``register_codec``).
``channel``— ``Channel`` transport interface + in-process transport moving
             only encoded buffers, with byte counters and the ledger a
             checkpoint carries; ``FaultyChannel`` injects seeded transport
             faults (drop/truncate/bit-flip).
``transport`` — length-prefixed socket transport (``SocketServer`` +
             worker-side ``ServerLink``) between a server process and N
             locally spawned worker processes; deadlines, backoff retries
             and heartbeat liveness map every wire fault onto the
             ``delivered=False`` branch of the fault model.
"""
from repro_torch.comm.channel import (Channel, FaultyChannel,
                                      InProcessChannel, LinkStats)
from repro_torch.comm.codec import (CODECS, Codec, make_codec,
                                    register_codec, wire_bytes)
from repro_torch.comm.frame import (FrameError, FrameSpec, parse_header,
                                    register_kind_id)
from repro_torch.comm.transport import (ProtocolError, ServerLink,
                                        SocketServer, spawn_local_workers)

__all__ = ["CODECS", "Channel", "Codec", "FaultyChannel", "FrameError",
           "FrameSpec", "InProcessChannel", "LinkStats", "ProtocolError",
           "ServerLink", "SocketServer", "make_codec", "parse_header",
           "register_codec", "register_kind_id", "spawn_local_workers",
           "wire_bytes"]
