"""RunConfig: the knobs of one federated run, validated at construction.

The fields the port runs: the FL schedule (``fl``), the client fan-out
(the single-process loop, or ``'shard_map'`` over the ranks of ``mesh``,
``repro_torch.fl.sharding``), the wire mode and its dtype policy, fused
decode, microbatching, the fault model (``repro_torch.fl.faults``), the
transport (``'inproc'``, or ``'socket'``: a ``SocketServer`` and N worker
processes, ``repro_torch.comm.transport``) with its deadline, backoff and
liveness knobs, and the checkpoint cadence (``repro_torch.checkpoint``).
The checks copy the JAX package's ``configs/run.py``. ``mesh`` is runtime
state: ``to_json`` leaves it out and ``from_json`` takes it separately.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import CompressorConfig, FLConfig

CLIENT_PARALLEL_MODES = ("vmap", "shard_map")
WIRE_MODES = ("float", "codec")
TRANSPORT_MODES = ("inproc", "socket")


@dataclass(frozen=True)
class RunConfig:
    """One federated run: FL schedule + compressor + fan-out knobs."""

    fl: FLConfig = field(default_factory=FLConfig)
    # client fan-out: 'vmap' is the single-process loop over clients;
    # 'shard_map' runs each rank's own clients and gathers their messages
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
    # -- fault model (repro_torch.fl.faults) -------------------------------
    # fraction of clients scheduled each round; 1.0 = everyone (no faults)
    participation_rate: float = 1.0
    # probability a participating client's payload is lost mid-round
    drop_rate: float = 0.0
    # probability a delivered payload is a straggler (arrives 1..staleness_max
    # rounds late); requires staleness_max >= 1
    straggler_rate: float = 0.0
    # staleness bound k: round-t payloads may arrive up to round t+k, held
    # in the FLState ring buffer with weight 1/(1+delay). 0 = buffer off.
    staleness_max: int = 0
    # seed of the fault stream: schedules are a pure function of
    # (fault_seed, round)
    fault_seed: int = 0
    # -- transport (repro_torch.comm.transport) ----------------------------
    # how rounds move: 'inproc' (one process, the engine's loop) or
    # 'socket' (a SocketServer + N worker processes over the live loop)
    transport: str = "inproc"
    # hard bound on one round's collect phase
    round_deadline_s: float = 30.0
    # per-client receive window before the first RESEND ...
    recv_timeout_s: float = 2.0
    # ... growing by this factor per attempt (exponential backoff)
    recv_backoff: float = 2.0
    # RESENDs before a client is given up as dropped this round
    transport_retries: int = 2
    # worker liveness tick period (heartbeats flow even mid-compute) ...
    heartbeat_s: float = 0.5
    # ... and how long silence lasts before a worker counts as dead
    liveness_timeout_s: float = 5.0
    # -- recovery (repro_torch.checkpoint) ---------------------------------
    # full-state checkpoint cadence in rounds (0 = final only)
    ckpt_every: int = 0
    # -- runtime (never serialized) ----------------------------------------
    # the DeviceMesh of the shard_map fan-out (repro_torch.launch.mesh)
    mesh: Any = field(default=None, compare=False, repr=False)

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
        if self.transport == "socket":
            if self.wire != "codec":
                raise ValueError(
                    "transport='socket' requires wire='codec': only framed "
                    "uint8 buffers cross a real wire")
            if self.client_parallel != "vmap":
                raise ValueError(
                    "transport='socket' requires client_parallel='vmap': "
                    "worker processes ARE the client fan-out (shard_map is "
                    "the in-process mesh path)")
            if self.has_faults:
                raise ValueError(
                    "transport='socket' is incompatible with the schedule-"
                    "driven fault knobs: on a live wire, faults are real "
                    "transport events (timeouts, corruption, dead workers) "
                    "mapped onto delivered=False — inject them at the "
                    "transport (SocketServer rx_filter) instead")
        if self.round_deadline_s <= 0.0:
            raise ValueError(
                f"round_deadline_s must be > 0, got {self.round_deadline_s}")
        if self.recv_timeout_s <= 0.0:
            raise ValueError(
                f"recv_timeout_s must be > 0, got {self.recv_timeout_s}")
        if self.recv_backoff < 1.0:
            raise ValueError(
                f"recv_backoff must be >= 1.0, got {self.recv_backoff}")
        if self.transport_retries < 0:
            raise ValueError(
                f"transport_retries must be >= 0, got "
                f"{self.transport_retries}")
        if self.heartbeat_s <= 0.0:
            raise ValueError(
                f"heartbeat_s must be > 0, got {self.heartbeat_s}")
        if self.liveness_timeout_s <= self.heartbeat_s:
            raise ValueError(
                f"liveness_timeout_s ({self.liveness_timeout_s}) must "
                f"exceed heartbeat_s ({self.heartbeat_s}) — a window "
                f"shorter than one heartbeat declares every worker dead")
        if self.ckpt_every < 0:
            raise ValueError(
                f"ckpt_every must be >= 0 (0 = final checkpoint only), got "
                f"{self.ckpt_every}")
        if self.fused_decode and self.staleness_max > 0:
            raise ValueError(
                "fused_decode is incompatible with staleness_max > 0: the "
                "staleness buffer banks per-client reconstructions, which "
                "the fused aggregate never materializes")
        if self.client_parallel == "shard_map":
            if self.mesh is None:
                raise ValueError(
                    "client_parallel='shard_map' requires an explicit mesh "
                    "(see repro_torch.fl.sharding.make_fl_shardings)")
            self.shardings().check_divisible(self.fl.num_clients)

    @property
    def has_faults(self) -> bool:
        """True when any fault knob is non-default: the round builder then
        runs the masked fault pipeline."""
        return (self.participation_rate < 1.0 or self.drop_rate > 0.0
                or self.straggler_rate > 0.0 or self.staleness_max > 0)

    def shardings(self):
        """The mesh's ``FLShardings`` (shard_map only)."""
        # fl.sharding sits above this package: imported here
        from repro_torch.fl.sharding import make_fl_shardings
        return make_fl_shardings(self.mesh)

    def client_axes(self) -> Optional[Tuple[str, ...]]:
        """Mesh axes of the shard_map fan-out; None for the vmap fan-out."""
        if self.client_parallel != "shard_map":
            return None
        return self.shardings().axes

    def retry_policy(self):
        """The transport ``RetryPolicy`` these knobs describe: retry count
        and backoff schedule, single receive windows capped by the round
        deadline (no receive may outwait the round)."""
        # fl.engine sits above this package: imported here
        from repro_torch.fl.engine import RetryPolicy
        return RetryPolicy(
            max_retries=self.transport_retries,
            recv_timeout_s=self.recv_timeout_s,
            recv_backoff=self.recv_backoff,
            max_timeout_s=max(self.round_deadline_s, self.recv_timeout_s))

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> Dict[str, Any]:
        """JSON-serializable dict of every field but the runtime ``mesh``."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
               if f.name != "mesh"}
        out["fl"] = dataclasses.asdict(self.fl)
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any], *, mesh=None) -> "RunConfig":
        """Inverse of ``to_json`` (the runtime ``mesh`` re-attached); keys
        a JSON predating a field take the field's default."""
        fl_d = dict(d["fl"])
        comp = CompressorConfig(**fl_d.pop("compressor"))
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name not in ("fl", "mesh") and f.name in d}
        return cls(fl=FLConfig(compressor=comp, **fl_d), mesh=mesh, **kw)

    @classmethod
    def from_flags(cls, args, *, compressor, client_parallel: str = "vmap",
                   mesh=None) -> "RunConfig":
        """Build from the training CLI's argparse namespace.
        ``client_parallel`` arrives already de-'auto'-ed (the world-size
        probe is the trainer's, ``launch.train.make_fanout``)."""
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
                   client_parallel=client_parallel,
                   mesh=mesh,
                   wire=getattr(args, "wire", "float"),
                   fused_decode=getattr(args, "fused_decode", False),
                   wire_policy=getattr(args, "wire_policy", "fp32"),
                   participation_rate=getattr(args, "participation_rate", 1.0),
                   drop_rate=getattr(args, "drop_rate", 0.0),
                   straggler_rate=getattr(args, "straggler_rate", 0.0),
                   staleness_max=getattr(args, "staleness_max", 0),
                   fault_seed=getattr(args, "fault_seed", 0),
                   transport=getattr(args, "transport", "inproc"),
                   round_deadline_s=getattr(args, "round_deadline_s", 30.0),
                   recv_timeout_s=getattr(args, "recv_timeout_s", 2.0),
                   recv_backoff=getattr(args, "recv_backoff", 2.0),
                   transport_retries=getattr(args, "transport_retries", 2),
                   heartbeat_s=getattr(args, "heartbeat_s", 0.5),
                   liveness_timeout_s=getattr(args, "liveness_timeout_s",
                                              5.0),
                   ckpt_every=getattr(args, "ckpt_every", 0))
