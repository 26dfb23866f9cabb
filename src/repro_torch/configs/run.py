"""RunConfig: the knobs of one federated run, validated at construction.

The fields the port runs: the FL schedule (``fl``), the client fan-out,
the wire mode and its dtype policy, fused decode, microbatching and the
fault and transport knobs at their defaults. The checks copy the JAX
package's ``configs/run.py`` for these fields; a knob whose path is not
ported yet (``client_parallel='shard_map'``, ``transport='socket'``, any
fault) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

from repro_torch.configs.base import FLConfig

CLIENT_PARALLEL_MODES = ("vmap", "shard_map")
WIRE_MODES = ("float", "codec")
TRANSPORT_MODES = ("inproc", "socket")

_NOT_PORTED = "not ported yet, see ROADMAP.md"


@dataclass(frozen=True)
class RunConfig:
    """One federated run: FL schedule + compressor + fan-out knobs."""

    fl: FLConfig = field(default_factory=FLConfig)
    # client fan-out: 'vmap' is the single-device loop over clients
    client_parallel: str = "vmap"
    # what crosses the client/server boundary: float trees (accounted
    # bytes) or framed uint8 codec buffers (measured bytes)
    wire: str = "float"
    # dtype policy for the serialized synthetic payload (codec wire only)
    wire_policy: str = "fp32"
    # strategy-declared capability: aggregate from the batched payloads
    # (3SFC: one backward over every (D_syn, s)) instead of reconstructions
    fused_decode: bool = False
    # gradient microbatching depth inside each local step
    num_micro: int = 1
    # -- fault model: every knob at its zero-fault default ----------------
    participation_rate: float = 1.0
    drop_rate: float = 0.0
    straggler_rate: float = 0.0
    staleness_max: int = 0
    fault_seed: int = 0
    # -- transport ---------------------------------------------------------
    transport: str = "inproc"

    def __post_init__(self):
        if self.client_parallel not in CLIENT_PARALLEL_MODES:
            raise ValueError(
                f"client_parallel must be 'vmap' or 'shard_map', got "
                f"{self.client_parallel!r}")
        if self.wire not in WIRE_MODES:
            raise ValueError(
                f"wire must be 'float' or 'codec', got {self.wire!r}")
        if self.num_micro < 1:
            raise ValueError(f"num_micro must be >= 1, got {self.num_micro}")
        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError(
                f"participation_rate must be in (0, 1], got "
                f"{self.participation_rate}")
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(
                f"drop_rate must be in [0, 1), got {self.drop_rate}")
        if not 0.0 <= self.straggler_rate <= 1.0:
            raise ValueError(
                f"straggler_rate must be in [0, 1], got {self.straggler_rate}")
        if self.staleness_max < 0:
            raise ValueError(
                f"staleness_max must be >= 0, got {self.staleness_max}")
        if self.straggler_rate > 0.0 and self.staleness_max < 1:
            raise ValueError(
                "straggler_rate > 0 requires staleness_max >= 1 (a straggler "
                "needs a buffer slot to land in)")
        if self.transport not in TRANSPORT_MODES:
            raise ValueError(
                f"transport must be 'inproc' or 'socket', got "
                f"{self.transport!r}")
        if self.fused_decode and self.staleness_max > 0:
            raise ValueError(
                "fused_decode is incompatible with staleness_max > 0: the "
                "staleness buffer banks per-client reconstructions, which "
                "the fused aggregate never materializes")
        if self.client_parallel == "shard_map":
            raise NotImplementedError(
                f"client_parallel='shard_map' {_NOT_PORTED}")
        if self.transport == "socket":
            raise NotImplementedError(f"transport='socket' {_NOT_PORTED}")
        if self.has_faults:
            raise NotImplementedError(f"the fault model {_NOT_PORTED}")

    @property
    def has_faults(self) -> bool:
        """True when any fault knob is non-default."""
        return (self.participation_rate < 1.0 or self.drop_rate > 0.0
                or self.straggler_rate > 0.0 or self.staleness_max > 0)

    def to_json(self) -> Dict[str, Any]:
        """JSON-serializable dict of every field."""
        return dataclasses.asdict(self)

    @classmethod
    def from_flags(cls, args, *, compressor) -> "RunConfig":
        """Build from the training CLI's argparse namespace."""
        fl = FLConfig(
            num_clients=args.clients,
            local_steps=args.local_steps,
            local_lr=args.lr,
            local_batch=args.batch,
            rounds=args.rounds,
            dirichlet_alpha=getattr(args, "alpha", 0.5),
            compressor=compressor,
            seed=args.seed,
        )
        return cls(fl=fl,
                   wire=getattr(args, "wire", "float"),
                   wire_policy=getattr(args, "wire_policy", "fp32"))
