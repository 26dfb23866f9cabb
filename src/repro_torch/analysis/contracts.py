"""Contracts over recorded eager rounds: the reference's five IR contracts,
defined for eager PyTorch.

The JAX package checks its contracts against the compiled HLO of every
round configuration. Eager PyTorch compiles no module, so the port's
artifact is a *recorded* run of one round (``repro_torch.analysis.ir``
builds one per configuration): while the round runs, ``RoundRecorder``

* wraps every collective entry point of ``torch.distributed`` (in
  ``torch.distributed`` and ``torch.distributed.distributed_c10d``) and
  records each call's kind, the bytes this rank puts into it, their dtypes
  and whether the call fell inside a client's step, through
  ``repro_torch.utils.hlo_analyzer.collective_hook``: the op-trace cost
  analyzer sees collectives through the same hook, so the two accountings
  cannot drift;
* records the row layout ``repro_torch.fl.sharding.all_gather_rows``
  packs: each gathered client row's fields, as (dtype, bytes) per leaf;
* counts, inside the client scope, the calls that pull a tensor's value to
  the host (``HOST_READS``), through a ``TorchFunctionMode`` entered
  around every client's step.

The contracts hold the reference's matrix, whose meshes have a ``model``
axis of 1. Under tensor parallelism (a ``model`` axis larger than 1) the
``model`` axis's collectives are the partitioner's: DTensor's functional
collectives, issued inside every client's step as GSPMD's are inside the
reference's per-client region, not the client scope's traffic across the
client axes. The recorder does not see them (they bypass the
``torch.distributed`` entry points it wraps); the op-trace analyzer counts
them (``hlo_analyzer.functional_collective``).

The client scope is ``repro_torch.fl.round.CLIENT_SCOPE``: the round wraps
each client's local training and encode in a profiler range of that name
and in ``client_scope()``, whose hooks (``SCOPE_HOOKS``) the recorder
installs. Every patch is undone when the recorder exits.

The five contracts (constants copied from the reference):

* ``client-scope-clean`` — no collective inside the client scope; a
  mesh-free round issues no collective at all (and a sharded one at least
  one, or the recorder missed its boundary).
* ``fused-gather-bounded`` — the all-gather bytes this rank sends stay
  within ``FUSED_GATHER_FACTOR`` × the local payload bytes +
  ``FUSED_GATHER_SLACK_BYTES``.
* ``no-host-sync-in-client-scope`` (the reference's ``no-host-callbacks``)
  — the client scope pulls no value to the host, except a strategy's count
  named in ``EXPECTED_HOST_SYNCS``.
* ``ef-donation-in-place`` (the reference's ``ef-donation-aliased``) —
  under ``RoundEngine(donate=True)`` each EF leaf of the returned state
  lives in the storage of the leaf handed in.
* ``wire-dtype-policy`` — in codec mode the policy is registered and the
  frame outgrows its header; under shard_map each local client's message
  crosses the gather as one ``uint8`` leaf of exactly ``codec.nbytes``,
  the other fields total at most ``WIRE_METADATA_SLACK_BYTES`` and the
  gathered buffer holds those rows and nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.comm.frame import HEADER_BYTES, POLICY_IDS
from repro_torch.core.tree import tree_leaves
from repro_torch.fl import round as round_lib
from repro_torch.fl.round import CLIENT_SCOPE
from repro_torch.utils.hlo_analyzer import collective_hook

# fused-decode gather bound: total gathered bytes per rank must stay within
# FACTOR x the local clients' payload bytes plus SLACK for the per-client
# metrics in the same rows — the O(N·payload) claim, as a constant
FUSED_GATHER_FACTOR = 2.0
FUSED_GATHER_SLACK_BYTES = 1024.0

# codec mode: non-u8 bytes (losses, cosines, payload floats) allowed in the
# gathered rows before it counts as a float tree leaking onto the wire
WIRE_METADATA_SLACK_BYTES = 1024.0

# host reads a strategy's client step needs, by kind: each entry names its
# file:line and reason. No built-in strategy needs one.
EXPECTED_HOST_SYNCS: Dict[str, int] = {}

# Tensor methods that pull a value to the host (a device sync on the card)
HOST_READS = ("item", "tolist", "numpy", "__array__", "__bool__",
              "__float__", "__int__", "__index__", "cpu")
_HOST_READ_FUNCS = {getattr(torch.Tensor, n): n for n in HOST_READS}


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------


@dataclass
class Collective:
    """One collective call: its entry point, the bytes this rank put into
    it, their dtypes, and whether it ran inside a client's step."""

    kind: str
    nbytes: int
    dtypes: List[str]
    in_scope: bool


@dataclass
class RoundRecord:
    """One recorded round configuration, everything a Contract may probe.

    ``config`` is the matrix point (kind/fanout/wire/fused/faulted). The
    recorder fills ``collectives``, ``rows`` (per gathered client row, per
    field, its leaves' (dtype, bytes)) and ``host_syncs`` (host reads in
    the client scope, by method); ``ir.record_round`` fills the EF leaves'
    storages handed to and returned by the round, whether the engine
    donated, and the config-derived expectations: the local payload bytes
    (fused gather bound) and the codec's layout (wire dtype).
    """

    config: Dict[str, Any]
    collectives: List[Collective] = field(default_factory=list)
    rows: List[List[List[Tuple[str, int]]]] = field(default_factory=list)
    host_syncs: Dict[str, int] = field(default_factory=dict)
    donate: bool = True
    ef_in: List[int] = field(default_factory=list)
    ef_out: List[int] = field(default_factory=list)
    payload_bytes_local: Optional[float] = None
    codec_nbytes: Optional[int] = None
    codec_policy: Optional[str] = None
    num_clients: int = 0
    client_shards: int = 1

    @property
    def label(self) -> str:
        c = self.config
        return (f"{c.get('kind')}/{c.get('fanout')}/{c.get('wire')}"
                + ("/fused" if c.get("fused") else "")
                + ("/faulted" if c.get("faulted") else ""))

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RoundRecord":
        d = dict(d)
        d["collectives"] = [Collective(**c) for c in d["collectives"]]
        d["rows"] = [[[tuple(l) for l in f] for f in row]
                     for row in d["rows"]]
        return cls(**d)


def ef_storages(ef) -> List[int]:
    """The storage address of each EF leaf."""
    return [t.untyped_storage().data_ptr() for t in tree_leaves(ef)]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def _target_is_cpu(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call names the CPU as its device."""
    for a in list(args[1:]) + [kwargs.get("device")]:
        if isinstance(a, str) and a.split(":")[0] == "cpu":
            return True
        if isinstance(a, torch.device) and a.type == "cpu":
            return True
    return False


class _HostReads(TorchFunctionMode):
    """Counts the host reads made while it is active."""

    def __init__(self, counts: Dict[str, int]):
        super().__init__()
        self.counts = counts

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _HOST_READ_FUNCS.get(func)
        if name is None and func is torch.Tensor.to \
                and _target_is_cpu(args, kwargs):
            name = "to(cpu)"
        if name is not None:
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **kwargs)


class RoundRecorder:
    """Records collectives, gathered rows and client-scope host reads while
    active (``with RoundRecorder() as rec: ...``); see the module
    docstring."""

    def __init__(self):
        self.collectives: List[Collective] = []
        self.rows: List[List[List[Tuple[str, int]]]] = []
        self.host_syncs: Dict[str, int] = {}
        self._stack = contextlib.ExitStack()

    def _on_collective(self, kind: str, operands) -> None:
        dtypes: List[str] = []
        for dt, _ in operands:
            if dt not in dtypes:
                dtypes.append(dt)
        self.collectives.append(Collective(
            kind, int(sum(b for _, b in operands)), dtypes,
            round_lib.in_client_scope()))

    def _wrap_rows(self, fn: Callable) -> Callable:
        rec = self

        def all_gather_rows(rows, group):
            for row in rows:
                fields = row if isinstance(row, tuple) else (row,)
                rec.rows.append([[(str(t.dtype), t.numel() * t.element_size())
                                  for t in tree_leaves(f)] for f in fields])
            return fn(rows, group)

        return all_gather_rows

    def __enter__(self) -> "RoundRecorder":
        # the gather's module (DTensor's import) is loaded here, not at
        # this module's import
        from repro_torch.fl import sharding
        with contextlib.ExitStack() as stack:
            stack.enter_context(collective_hook(self._on_collective))
            gather = sharding.all_gather_rows
            sharding.all_gather_rows = self._wrap_rows(gather)
            stack.callback(setattr, sharding, "all_gather_rows", gather)
            hook = lambda: _HostReads(self.host_syncs)
            round_lib.SCOPE_HOOKS.append(hook)
            stack.callback(round_lib.SCOPE_HOOKS.remove, hook)
            self._stack = stack.pop_all()
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Contract:
    """One declarative rule: ``applies`` scopes it to the matrix points it
    is meaningful for, ``check`` returns violation messages (empty =
    clean)."""

    name: str
    description: str
    applies: Callable[[RoundRecord], bool]
    check: Callable[[RoundRecord], List[str]]


def _sharded(r: RoundRecord) -> bool:
    return r.config.get("fanout") == "shard_map"


def _gathers(r: RoundRecord) -> List[Collective]:
    return [c for c in r.collectives if c.kind.lstrip("_").startswith(
        "all_gather")]


def _check_client_scope(r: RoundRecord) -> List[str]:
    if _sharded(r):
        if not r.collectives:
            return [f"{r.label}: no collective recorded in a sharded round "
                    f"(its boundary gather went unseen)"]
        return [f"{r.label}: {c.kind} ({c.nbytes} B) inside {CLIENT_SCOPE}"
                for c in r.collectives if c.in_scope]
    return [f"{r.label}: {c.kind} ({c.nbytes} B) in a mesh-free round"
            for c in r.collectives]


def _check_fused_gather(r: RoundRecord) -> List[str]:
    if r.payload_bytes_local is None:
        return [f"{r.label}: fused record carries no payload_bytes_local"]
    gathers = _gathers(r)
    if not gathers:
        return [f"{r.label}: no all-gather recorded in a sharded fused "
                f"round"]
    sent = sum(c.nbytes for c in gathers)
    bound = (FUSED_GATHER_FACTOR * r.payload_bytes_local
             + FUSED_GATHER_SLACK_BYTES)
    if sent > bound:
        return [f"{r.label}: fused gather moves {sent} B > bound "
                f"{bound:.0f} B ({FUSED_GATHER_FACTOR}x local payload "
                f"{r.payload_bytes_local:.0f} B + "
                f"{FUSED_GATHER_SLACK_BYTES:.0f} B slack)"]
    return []


def _check_host_syncs(r: RoundRecord) -> List[str]:
    total = sum(r.host_syncs.values())
    allowed = EXPECTED_HOST_SYNCS.get(r.config.get("kind"), 0)
    if total != allowed:
        return [f"{r.label}: {total} host read(s) inside {CLIENT_SCOPE} "
                f"({r.host_syncs}), {allowed} expected"]
    return []


def _check_ef_donation(r: RoundRecord) -> List[str]:
    if not r.ef_in or len(r.ef_in) != len(r.ef_out):
        return [f"{r.label}: {len(r.ef_in)} EF leaves handed in, "
                f"{len(r.ef_out)} returned"]
    moved = [i for i, (a, b) in enumerate(zip(r.ef_in, r.ef_out)) if a != b]
    if moved:
        return [f"{r.label}: EF leaf/leaves {moved} of {len(r.ef_in)} not "
                f"in the donated storage (donate={r.donate}): the round "
                f"held a second EF tree"]
    return []


def _check_wire_dtype(r: RoundRecord) -> List[str]:
    probs: List[str] = []
    if r.codec_policy not in POLICY_IDS:
        probs.append(f"{r.label}: codec declares unregistered dtype policy "
                     f"{r.codec_policy!r} (registered: {sorted(POLICY_IDS)})")
    if r.codec_nbytes is None or r.codec_nbytes <= HEADER_BYTES:
        probs.append(f"{r.label}: codec frame size {r.codec_nbytes} must "
                     f"exceed the {HEADER_BYTES} B header")
        return probs
    if not _sharded(r):
        return probs        # no boundary collective to inspect mesh-free
    local = r.num_clients // max(r.client_shards, 1)
    if len(r.rows) != local:
        probs.append(f"{r.label}: {len(r.rows)} rows gathered, {local} "
                     f"local clients")
    frame = [("torch.uint8", r.codec_nbytes)]
    other = 0
    for j, row in enumerate(r.rows):
        framed = bool(row) and row[0] == frame
        if not framed:
            probs.append(f"{r.label}: row {j}'s message crosses the gather "
                         f"as {row[0] if row else None}, not one uint8 "
                         f"frame of {r.codec_nbytes} B")
        # every byte but the frame's is metadata
        other += sum(b for f in row[1 if framed else 0:] for _, b in f)
    if other > WIRE_METADATA_SLACK_BYTES:
        probs.append(f"{r.label}: {other} B of non-frame fields in the "
                     f"gathered rows (> {WIRE_METADATA_SLACK_BYTES:.0f} B "
                     f"metrics slack) — a float tree is crossing the wire")
    packed = sum(b for row in r.rows for f in row for _, b in f)
    gathers = _gathers(r)
    sent = sum(c.nbytes for c in gathers)
    if sent != packed or any(c.dtypes != ["torch.uint8"] for c in gathers):
        probs.append(f"{r.label}: the gather sends {sent} B "
                     f"({[c.dtypes for c in gathers]}), the rows pack "
                     f"{packed} B as uint8")
    return probs


CONTRACTS: Tuple[Contract, ...] = (
    Contract(
        "client-scope-clean",
        f"zero collectives inside the per-client region ({CLIENT_SCOPE}); "
        f"mesh-free rounds are collective-free",
        lambda r: True,
        _check_client_scope),
    Contract(
        "fused-gather-bounded",
        f"fused-decode all-gather bytes bounded by {FUSED_GATHER_FACTOR}x "
        f"local payload + {FUSED_GATHER_SLACK_BYTES:.0f} B",
        lambda r: bool(r.config.get("fused")) and _sharded(r),
        _check_fused_gather),
    Contract(
        "no-host-sync-in-client-scope",
        f"no host read of a tensor's value inside {CLIENT_SCOPE} beyond "
        f"EXPECTED_HOST_SYNCS",
        lambda r: True,
        _check_host_syncs),
    Contract(
        "ef-donation-in-place",
        "under RoundEngine(donate=True) the returned EF leaves live in the "
        "donated leaves' storage",
        lambda r: True,
        _check_ef_donation),
    Contract(
        "wire-dtype-policy",
        "codec-mode boundary traffic is one uint8 frame per local client "
        "under a registered dtype policy; other fields are metrics-sized",
        lambda r: r.config.get("wire") == "codec",
        _check_wire_dtype),
)


def run_contracts(records: List[RoundRecord],
                  contracts: Tuple[Contract, ...] = CONTRACTS,
                  ) -> Dict[str, Any]:
    """Evaluate every contract against every record it applies to.

    Returns per-contract evaluation counts and violation messages, the
    covered config labels, the client-scope host reads per strategy kind,
    and totals — the reference's report shape.
    """
    per: Dict[str, Dict[str, Any]] = {}
    total_eval = 0
    total_viol = 0
    for c in contracts:
        evaluated = 0
        violations: List[str] = []
        for r in records:
            if not c.applies(r):
                continue
            evaluated += 1
            violations.extend(c.check(r))
        per[c.name] = {"description": c.description,
                       "evaluated": evaluated,
                       "violations": violations}
        total_eval += evaluated
        total_viol += len(violations)
    syncs: Dict[str, int] = {}
    for r in records:
        kind = r.config.get("kind")
        syncs[kind] = syncs.get(kind, 0) + sum(r.host_syncs.values())
    return {
        "configs": [r.label for r in records],
        "configs_evaluated": len(records),
        "contracts": per,
        "host_syncs_by_kind": dict(sorted(syncs.items())),
        "rules_evaluated": total_eval,
        "violations": total_viol,
    }
