"""Channel interface + in-process transport: only encoded buffers move.

The port of the JAX package's ``comm/channel.py`` without its
``FaultyChannel`` (the fault-injection wrapper comes with the faults
slice) and without the ledger snapshots and control-plane overhead
counters that its checkpoint and socket paths use (not ported yet).
``Channel`` keeps per-direction ``LinkStats`` byte accounting in explicit
per-round buckets opened by ``begin_round()``.
``InProcessChannel``'s client half may hand it nothing but framed 1-D
``uint8`` buffers — a tensor on any device or a numpy array — and the
server half receives a detached host copy (numpy), billed by its size.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


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


class Channel:
    """Transport interface: uplink/downlink byte accounting in per-round
    buckets. Subclasses move the bytes however they like but bill every
    data frame through ``LinkStats``."""

    def __init__(self):
        self.uplink = LinkStats()
        self.downlink = LinkStats()
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
