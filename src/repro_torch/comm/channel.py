"""Channel interface + in-process transport: only encoded buffers move.

The port of the JAX package's ``comm/channel.py``. ``Channel`` keeps
per-direction ``LinkStats`` byte accounting in explicit per-round buckets
opened by ``begin_round()``, plus control-plane overhead counters, and
snapshots both as the ``ledger()`` a checkpoint carries. Two transports
live behind it: ``InProcessChannel`` (below) and
``repro_torch.comm.transport.SocketServer`` (length-prefixed sockets
between processes); both bill only data frames into ``LinkStats``.
``InProcessChannel``'s client half may hand it nothing but framed 1-D
``uint8`` buffers — a tensor on any device or a numpy array — and the
server half receives a detached host copy (numpy), billed by its size.

``FaultyChannel`` wraps a channel with seeded transport-fault injection
(drop / truncation / bit flips), drawing from its numpy generator in the
reference's order, so the same seed and sends give byte-identical wire
output in both packages. Faults are attributed per round on top of the
running totals.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.obs import get_registry


@dataclasses.dataclass
class LinkStats:
    """Byte counters for one direction of the link."""

    total_bytes: int = 0
    messages: int = 0
    per_round: List[int] = dataclasses.field(default_factory=list)

    def _record(self, nbytes: int):
        # a send must land in an explicitly opened per-round bucket
        if not self.per_round:
            raise RuntimeError(
                "send before begin_round(): open a per-round accounting "
                "bucket first")
        self.total_bytes += nbytes
        self.messages += 1
        self.per_round[-1] += nbytes

    def _new_round(self):
        self.per_round.append(0)

    def snapshot(self) -> dict:
        """JSON-serializable ledger state (what a checkpoint carries)."""
        return {"total_bytes": int(self.total_bytes),
                "messages": int(self.messages),
                "per_round": [int(b) for b in self.per_round]}

    def restore(self, d: dict) -> None:
        """Reinstate a ``snapshot()``: a resumed run keeps billing into the
        same buckets, so round numbering continues from the checkpoint."""
        self.total_bytes = int(d["total_bytes"])
        self.messages = int(d["messages"])
        self.per_round = [int(b) for b in d["per_round"]]


class Channel:
    """Transport interface: uplink/downlink byte accounting in per-round
    buckets. Subclasses move the bytes however they like but bill every
    data frame through ``LinkStats``."""

    def __init__(self):
        self.uplink = LinkStats()
        self.downlink = LinkStats()
        # control-plane bytes (headers, acks, heartbeats, metric frames):
        # billed here, not into LinkStats, so "bytes per round" stays pure
        # data-frame bytes while the overhead stays in the ledger
        self.overhead_up = 0
        self.overhead_down = 0
        self._round = 0

    @property
    def round(self) -> int:
        return self._round

    def begin_round(self) -> int:
        """Open a new per-round accounting bucket; returns its index."""
        self.uplink._new_round()
        self.downlink._new_round()
        self._round = len(self.uplink.per_round) - 1
        return self._round

    def ledger(self) -> dict:
        """Both directions' ``LinkStats.snapshot()`` and the overhead — the
        byte ledger a full-state checkpoint carries."""
        return {"uplink": self.uplink.snapshot(),
                "downlink": self.downlink.snapshot(),
                "overhead_up": int(self.overhead_up),
                "overhead_down": int(self.overhead_down)}

    def restore_ledger(self, d: dict) -> None:
        """Reinstate a ``ledger()`` snapshot; the next ``begin_round``
        continues the restored numbering. Overhead keys default to 0."""
        self.uplink.restore(d["uplink"])
        self.downlink.restore(d["downlink"])
        self.overhead_up = int(d.get("overhead_up", 0))
        self.overhead_down = int(d.get("overhead_down", 0))
        self._round = max(len(self.uplink.per_round) - 1, 0)


class InProcessChannel(Channel):
    """Moves encoded uint8 buffers client->server (uplink) and
    server->client (downlink), billing every byte."""

    @staticmethod
    def _as_wire(buf) -> np.ndarray:
        if isinstance(buf, torch.Tensor):
            buf = buf.detach().cpu().numpy()
        b = np.asarray(buf)
        if b.dtype != np.uint8 or b.ndim != 1:
            raise TypeError(
                f"channel carries 1-D uint8 frames only, got "
                f"{b.dtype}{list(b.shape)} — encode first "
                f"(repro_torch.comm.codec)")
        return b.copy()                  # the wire: a detached host copy

    def send_up(self, buf) -> np.ndarray:
        """Client -> server. Returns the host copy the server receives."""
        b = self._as_wire(buf)
        self.uplink._record(b.nbytes)
        return b

    def send_down(self, buf) -> np.ndarray:
        """Server -> client (e.g. a framed model broadcast)."""
        b = self._as_wire(buf)
        self.downlink._record(b.nbytes)
        return b


class FaultyChannel:
    """Seeded transport-fault injector over an inner channel.

    Each send first pays the inner channel's billing (corruption happens
    on the wire, not before it), then the frame is dropped (``None``),
    truncated to a random prefix, or hit with single-bit flips, with the
    configured probabilities, deterministic from ``seed`` and the send
    sequence. Rounds must be opened on this wrapper (``begin_round``) so
    the per-round fault buckets stay aligned with the byte buckets.
    """

    def __init__(self, inner: Optional[InProcessChannel] = None, *,
                 drop_prob: float = 0.0, truncate_prob: float = 0.0,
                 bitflip_prob: float = 0.0, max_bitflips: int = 8,
                 seed: int = 0):
        for name, p in (("drop_prob", drop_prob),
                        ("truncate_prob", truncate_prob),
                        ("bitflip_prob", bitflip_prob)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.inner = InProcessChannel() if inner is None else inner
        self.drop_prob = drop_prob
        self.truncate_prob = truncate_prob
        self.bitflip_prob = bitflip_prob
        self.max_bitflips = max_bitflips
        self._rng = np.random.default_rng(seed)
        self.dropped = 0
        self.corrupted = 0
        self.dropped_per_round: List[int] = []
        self.corrupted_per_round: List[int] = []
        # pull-model meter: /metrics renders the live fault buckets
        get_registry().register_source("channel.faults", self.fault_stats)

    def fault_stats(self) -> dict:
        return {"dropped": int(self.dropped),
                "corrupted": int(self.corrupted),
                "dropped_per_round": [int(x) for x in self.dropped_per_round],
                "corrupted_per_round":
                    [int(x) for x in self.corrupted_per_round]}

    @property
    def uplink(self) -> LinkStats:
        return self.inner.uplink

    @property
    def downlink(self) -> LinkStats:
        return self.inner.downlink

    @property
    def round(self) -> int:
        return self.inner.round

    def begin_round(self) -> int:
        self.dropped_per_round.append(0)
        self.corrupted_per_round.append(0)
        return self.inner.begin_round()

    def _corrupt(self, b: np.ndarray) -> Optional[np.ndarray]:
        if not self.dropped_per_round:
            raise RuntimeError(
                "send before begin_round() on the FaultyChannel: open the "
                "round on the wrapper (not its inner channel) so per-round "
                "fault attribution stays aligned with the byte buckets")
        r = self._rng
        if r.random() < self.drop_prob:
            self.dropped += 1
            self.dropped_per_round[-1] += 1
            return None
        if r.random() < self.truncate_prob and b.size > 0:
            self.corrupted += 1
            self.corrupted_per_round[-1] += 1
            return b[: int(r.integers(0, b.size))].copy()
        if r.random() < self.bitflip_prob and b.size > 0:
            self.corrupted += 1
            self.corrupted_per_round[-1] += 1
            b = b.copy()
            for _ in range(int(r.integers(1, self.max_bitflips + 1))):
                pos = int(r.integers(0, b.size))
                b[pos] ^= np.uint8(1 << int(r.integers(0, 8)))
            return b
        return b

    def send_up(self, buf) -> Optional[np.ndarray]:
        """Client -> server through the faulty wire: the delivered frame,
        possibly corrupted, or ``None`` when the wire ate it."""
        return self._corrupt(self.inner.send_up(buf))

    def send_down(self, buf) -> Optional[np.ndarray]:
        return self._corrupt(self.inner.send_down(buf))
