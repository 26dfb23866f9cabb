"""Multi-round FL engine: device-resident data, on-device sampling.

* the training set and the Dirichlet partition live on the device
  (``device_pools`` pads the ragged per-client index lists to an ``(N, P)``
  pool matrix — padding is never sampled);
* per-round batches are gathered on the device (``vision_batcher``, and
  ``token_batcher`` for the LM runs) — no per-round host -> device
  transfer;
* ``RoundEngine`` runs rounds in blocks of ``eval_every`` and fetches a
  block's metrics to the host once, at its end.

Seeded-generator contract
-------------------------
The batch for (round r, client i) and the round's encoder seed are pure
functions of the engine seed and the *absolute* round counter::

    data_seed  = fold_in(seed, 0)        round_seed = fold_in(seed, 1)
    pos_i      = randint(Generator(fold_in(data_seed, r, i)), (K, B), size_i)
    batch_i    = gather(dataset, pools.index[i, pos_i])
    round key  = fold_in(round_seed, r)  (client i: fold_in(key, i))

so how rounds are grouped into blocks never changes the trajectory: blocks
[3] and [2, 1] give bitwise the same state (eval-cadence invariance). The
round's fault schedule is a pure function of ``(fault_seed, absolute
round)`` too (``repro_torch.fl.faults``), so the same holds under faults.

EF donation: ``RoundEngine(..., donate=True)`` (the default, as the
reference's) hands every round its input state to consume: the round
writes each client's new EF row into that state's own EF tensors
(``build_fl_round``'s ``donate=True``), so the N×d residual is never held
twice; where the round replays its encode as CUDA graphs
(``repro_torch.fl.encode_graph``) it writes the new params into the
state's params as well. Where JAX raises on a donated buffer's reuse, a torch tensor just
holds the next round's values, so a donated ``FLState`` must never be
touched after the call: every ``run*`` method returns the state that
replaces it, and the engine refuses a state whose EF it already donated to
a later round. ``init_state`` copies the params it is given, so the
caller's model tree survives; ``donate=False`` keeps every input state
intact, at one more N×d tree a round.

Sharded fan-out: with ``RoundEngine(..., shardings=FLShardings)``
(``repro_torch.fl.sharding``) every rank runs the same engine; its state
holds the EF rows of the rank's own clients (``init_state`` places it), and
its batcher, given the rank's client range (``clients=``), draws only
those clients' batches. A batch is a pure function of ``(seed, round,
client)``, so each client's batch is the one the single-process engine
draws for it.

Transport (the host half of the fault model): ``RoundEngine.deliver``
pushes a round's uplink frames through a (possibly faulty) channel under a
``RetryPolicy``; ``LiveRoundLoop`` is the server half of a live round over
``repro_torch.comm.transport.SocketServer``, whose clients are worker
processes (``repro_torch.launch.worker``). Its server step is the codec
round's own (``repro_torch.fl.round.codec_server_step``), so a live round
is bitwise the in-process codec round under the same delivered mask.

Recovery: ``RoundEngine.run(..., ckpt_every=, ckpt_fn=)`` fires the
checkpoint hook on multiples of ``ckpt_every`` of the absolute round
counter, and blocks end at the next boundary of either cadence, so a
resumed run checkpoints and evaluates at the rounds the uninterrupted one
does, with the same trajectory.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl.round import (FLState, RoundMetrics, codec_server_step,
                                  fl_init, fold_in)
from repro_torch.obs import get_registry, get_tracer

PyTree = Any
# batch_fn(data_seed, round_idx) -> per-client stacked batch tree (N, K, B, ...)
BatchFn = Callable[[int, int], PyTree]
RoundFn = Callable[[FLState, PyTree, int], Tuple[FLState, RoundMetrics]]

_DATA_FOLD = 0
_ROUND_FOLD = 1


class ClientPools(NamedTuple):
    """Padded on-device Dirichlet partition: ``index[i, :size[i]]`` are the
    dataset rows client ``i`` may sample; the rest is padding (zeros) that
    the sampler never reads."""

    index: torch.Tensor              # (N, P) int64
    size: torch.Tensor               # (N,) int64


def device_pools(parts: Sequence[np.ndarray],
                 device: torch.device) -> ClientPools:
    """Materialize a host-side partition (``data.partition.
    dirichlet_partition``) as device pools. A zero-sample client gets
    ``size`` 1 over its all-zeros row (it resamples dataset row 0), as in
    the reference."""
    cap = max(max(len(p) for p in parts), 1)
    index = np.zeros((len(parts), cap), np.int64)
    for i, p in enumerate(parts):
        index[i, : len(p)] = np.asarray(p, np.int64)
    size = np.array([max(len(p), 1) for p in parts], np.int64)
    return ClientPools(torch.as_tensor(index, device=device),
                       torch.as_tensor(size, device=device))


def vision_batcher(train_x: np.ndarray, train_y: np.ndarray,
                   pools: ClientPools, local_steps: int,
                   local_batch: int, *,
                   clients: Optional[range] = None) -> BatchFn:
    """Non-iid ``{"x", "y"}`` batches gathered from device-resident data.
    ``clients`` names the global client id of each row of ``pools`` (a
    rank's ``FLShardings.local_clients`` beside its ``place_pools`` rows);
    by default row i is client i."""
    device = pools.index.device
    x = torch.as_tensor(train_x, device=device)
    y = torch.as_tensor(train_y, device=device)
    sizes = pools.size.tolist()          # host copy: randint needs ints
    clients = range(len(sizes)) if clients is None else clients
    if len(clients) != len(sizes):
        raise ValueError(f"{len(clients)} client ids for {len(sizes)} pool "
                         f"rows")

    def batch_fn(data_seed: int, round_idx: int) -> PyTree:
        rows = []
        for j, (i, size) in enumerate(zip(clients, sizes)):
            gen = torch.Generator(device=device)
            gen.manual_seed(fold_in(data_seed, round_idx, i))
            pos = torch.randint(0, size, (local_steps, local_batch),
                                generator=gen, device=device)
            rows.append(pools.index[j, pos])
        idx = torch.stack(rows)
        return {"x": x[idx], "y": y[idx]}

    return batch_fn


def token_batcher(tokens: np.ndarray, num_clients: int, local_steps: int,
                  local_batch: int,
                  extras: Optional[Dict[str, Tuple[int, ...]]] = None, *,
                  device: Optional[torch.device] = None,
                  clients: Optional[range] = None) -> BatchFn:
    """IID ``{"tokens"}`` batches of shape (N, K, B, S) gathered from the
    token set, copied to ``device`` once; client ``i`` of round ``r`` draws
    its (K, B) rows uniformly from a generator seeded with
    ``fold_in(data_seed, r, i)``. ``extras`` maps a batch key to a trailing
    shape, materialized as ``(N, K, B, *shape)`` f32 zeros (the
    multimodal stubs). ``clients`` (a rank's ``FLShardings.local_clients``)
    draws those clients' rows only; by default all ``num_clients``."""
    device = torch.device("cpu") if device is None else torch.device(device)
    toks = torch.as_tensor(np.asarray(tokens), device=device)
    n = toks.shape[0]
    extras = dict(extras or {})
    clients = range(num_clients) if clients is None else clients

    def batch_fn(data_seed: int, round_idx: int) -> PyTree:
        rows = []
        for i in clients:
            gen = torch.Generator(device=device)
            gen.manual_seed(fold_in(data_seed, round_idx, i))
            rows.append(torch.randint(0, n, (local_steps, local_batch),
                                      generator=gen, device=device))
        batch = {"tokens": toks[torch.stack(rows)]}
        for name, shape in extras.items():
            batch[name] = torch.zeros(
                (len(clients), local_steps, local_batch, *shape),
                dtype=torch.float32, device=device)
        return batch

    return batch_fn


@dataclasses.dataclass
class EngineStats:
    """Dispatch and sync accounting of a ``RoundEngine``.

    ``rounds`` and ``host_syncs`` mean what they mean in the JAX package:
    one sync per ``run_block`` (its metrics' one fetch to the host), two
    per round in ``run_loop``. ``dispatches`` counts calls of the round
    function: the port makes one per round, where the reference's scanned
    block is one dispatch for all its rounds.
    """

    dispatches: int = 0              # round-function calls
    host_syncs: int = 0              # blocking device->host reads
    rounds: int = 0

    def per_round(self) -> Dict[str, float]:
        r = max(self.rounds, 1)
        return {"dispatches_per_round": self.dispatches / r,
                "host_syncs_per_round": self.host_syncs / r}


class RunHistory(NamedTuple):
    metrics: RoundMetrics            # stacked over all rounds (host arrays)
    evals: List[Tuple[int, Any]]     # (round, eval_fn result) per eval point


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Transport give-up policy: how often a rejected or late uplink frame
    is re-requested before the server treats that client as DROPPED this
    round (the ``delivered=False`` branch of ``repro_torch.fl.faults``: the
    client's EF keeps the whole update, the server renormalizes over what
    arrived). Every retry re-sends the same frame and is billed like any
    other send.

    Attempt ``a`` waits ``recv_timeout_s * recv_backoff**a`` seconds
    (exponential backoff), capped at ``max_timeout_s`` — which the socket
    trainer sets to the round deadline.
    """

    max_retries: int = 2
    recv_timeout_s: float = 2.0
    recv_backoff: float = 2.0
    max_timeout_s: float = 30.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.recv_timeout_s <= 0.0:
            raise ValueError(
                f"recv_timeout_s must be > 0, got {self.recv_timeout_s}")
        if self.recv_backoff < 1.0:
            raise ValueError(
                f"recv_backoff must be >= 1.0 (a shrinking retry window "
                f"races its own resends), got {self.recv_backoff}")
        if self.max_timeout_s < self.recv_timeout_s:
            raise ValueError(
                f"max_timeout_s ({self.max_timeout_s}) must be >= "
                f"recv_timeout_s ({self.recv_timeout_s})")

    def timeout(self, attempt: int) -> float:
        """Receive window for attempt ``attempt`` (0-based)."""
        return min(self.recv_timeout_s * self.recv_backoff ** attempt,
                   self.max_timeout_s)


class DeliveryReport(NamedTuple):
    """What ``RoundEngine.deliver`` (or ``SocketServer.collect``) got
    through the wire."""

    frames: List[Any]                # validated host frames; None = given up
    delivered: np.ndarray            # (N,) bool — the round's delivered mask
    retries: int                     # total re-sends across all clients


def _to_host(ms: List[RoundMetrics]) -> RoundMetrics:
    """Stack per-round metrics and fetch them to the host in one go."""
    def field(vals):
        if isinstance(vals[0], torch.Tensor):
            return torch.stack(vals).cpu().numpy()
        return np.asarray(vals, np.float32)
    return RoundMetrics(*[field([getattr(m, f) for m in ms])
                          for f in RoundMetrics._fields])


class RoundEngine:
    """Drives a ``build_fl_round`` round function over engine-sampled
    batches. ``run`` fetches metrics once per eval block; ``run_loop`` is
    the per-round reference loop with two scalar syncs per round. Both run
    the same rounds in the same order, so they agree bitwise. With
    ``donate`` (the default) each round consumes the state it is handed,
    its EF and, on the encode graph path, its params (see the module
    docstring); with ``shardings`` (the round built with
    ``client_parallel='shard_map'``) the state holds this rank's EF rows,
    and each rank donates its own."""

    def __init__(self, round_fn: RoundFn, batch_fn: BatchFn, *,
                 seed: int = 0, donate: bool = True, shardings=None):
        self._data_seed = fold_in(seed, _DATA_FOLD)
        self._round_seed = fold_in(seed, _ROUND_FOLD)
        self._round_fn = round_fn
        self._batch_fn = batch_fn
        self.donate = donate
        self._shardings = shardings
        # (weak reference to the first EF leaf of the last donated round's
        # state, that state's round): the EF leaves stay the same tensors
        # from round to round, so a state holding them at another round
        # has been consumed
        self._donated = None
        self.stats = EngineStats()

    def init_state(self, params: PyTree, num_clients: int,
                   strategy=None, *, staleness_max: int = 0) -> FLState:
        """``fl_init`` on a copy of ``params``, so the caller's tensors are
        never the state's (donation never consumes them), placed by the engine's shardings when it has
        them; pass ``staleness_max=run.staleness_max`` when the round was
        built with staleness."""
        state = fl_init(tree_map(torch.clone, params), num_clients, strategy,
                        staleness_max=staleness_max)
        if self._shardings is not None:
            state = self._shardings.place_state(state)
        return state

    @staticmethod
    def deliver(channel, frames, *,
                policy: RetryPolicy = RetryPolicy()) -> DeliveryReport:
        """Push per-client uplink frames through a (possibly faulty)
        channel with retry/give-up semantics.

        Each frame is sent via ``channel.send_up`` and validated with
        ``frame.parse_header``; a ``None`` delivery (the wire dropped it)
        or a ``FrameError`` (corrupt on arrival) triggers a re-send, up to
        ``policy.max_retries`` times. A client whose every attempt fails is
        marked undelivered — the ``delivered=False`` branch of the in-round
        fault model. Retries are billed by the channel like any send.
        """
        # comm sits beside fl: imported here
        from repro_torch.comm.frame import FrameError, parse_header

        tracer = get_tracer()
        out: List[Any] = []
        delivered = np.zeros((len(frames),), bool)
        retries = 0
        with tracer.span("engine.deliver", clients=len(frames)) as sp:
            for i, buf in enumerate(frames):
                got = None
                for attempt in range(policy.max_retries + 1):
                    if attempt > 0:
                        retries += 1
                        tracer.event("retry.resend", client=i,
                                     attempt=attempt)
                    wire = channel.send_up(buf)
                    if wire is None:
                        continue
                    try:
                        parse_header(wire)
                    except FrameError:
                        continue
                    got = wire
                    break
                out.append(got)
                delivered[i] = got is not None
                if got is None:
                    tracer.event("retry.give_up", client=i,
                                 attempts=policy.max_retries)
            sp.end(delivered=int(delivered.sum()), retries=retries)
        get_registry().counter("engine.deliver.retries").inc(retries)
        return DeliveryReport(out, delivered, retries)

    def _round(self, state: FLState) -> Tuple[FLState, RoundMetrics]:
        batches = self._batch_fn(self._data_seed, state.round)
        key = fold_in(self._round_seed, state.round)
        self.stats.dispatches += 1
        if not self.donate:
            return self._round_fn(state, batches, key)
        ef = tree_leaves(state.ef)
        if (self._donated is not None and ef
                and self._donated[0]() is ef[0]
                and state.round != self._donated[1]):
            raise RuntimeError(
                f"this FLState (round {state.round}) was donated to an "
                f"earlier round and its EF now holds round "
                f"{self._donated[1]}'s; continue from the state the engine "
                f"returned, or build the engine with donate=False")
        state, m = self._round_fn(state, batches, key, donate=True)
        ef = tree_leaves(state.ef)
        self._donated = (weakref.ref(ef[0]), state.round) if ef else None
        return state, m

    def run_block(self, state: FLState,
                  length: int) -> Tuple[FLState, RoundMetrics]:
        """``length`` rounds; their metrics come back to the host at the end
        of the block. Span tags use the engine's own round count, never a
        device read. With tracing on, ``engine.sync`` settles the block's
        device marks and folds its spans into the meter registry
        (``Tracer.settle``)."""
        tracer = get_tracer()
        r0 = self.stats.rounds
        ms = []
        with tracer.span("engine.dispatch", block=length, rounds_done=r0):
            for _ in range(length):
                state, m = self._round(state)
                ms.append(m)
        with tracer.span("engine.sync", block=length, rounds_done=r0):
            host = _to_host(ms)
            # the block's phase spans get their device times here, at the
            # sync the block makes anyway (tracing on only)
            end = (tracer.sync_point(tree_leaves(state.params)[0].device)
                   if tracer.enabled else None)
        if end is not None:
            tracer.settle(*end, rounds=length)
        self.stats.host_syncs += 1
        self.stats.rounds += length
        return state, host

    def run(self, state: FLState, num_rounds: int, *, eval_every: int = 0,
            eval_fn: Optional[Callable[[FLState, RoundMetrics, int], Any]]
            = None, ckpt_every: int = 0,
            ckpt_fn: Optional[Callable[[FLState, int], Any]] = None,
            ) -> Tuple[FLState, RunHistory]:
        """Blocks of rounds, with ``eval_fn(state, block_metrics,
        rounds_done)`` called at each eval boundary ((r+1) % eval_every ==
        0, plus the final round) and ``ckpt_fn(state, absolute_round)``
        whenever the absolute round counter (``FLState.round``: a resumed
        state starts past 0) reaches a multiple of ``ckpt_every``. Blocks
        end at the next boundary of either cadence on the absolute counter;
        batches and encoder draws are pure functions of that counter, so
        how rounds are grouped never changes the trajectory."""
        r0 = state.round
        target = r0 + num_rounds

        def boundary(cur: int, every: int) -> int:
            return (cur // every + 1) * every if every > 0 else target

        chunks: List[RoundMetrics] = []
        evals: List[Tuple[int, Any]] = []
        cur = r0
        while cur < target:
            nxt = min(boundary(cur, eval_every), boundary(cur, ckpt_every),
                      target)
            state, ms = self.run_block(state, nxt - cur)
            cur = nxt
            chunks.append(ms)
            if eval_fn is not None and (
                    cur == target or (eval_every > 0 and cur % eval_every == 0)):
                evals.append((cur - r0, eval_fn(state, ms, cur - r0)))
            if ckpt_fn is not None and ckpt_every > 0 \
                    and cur % ckpt_every == 0:
                ckpt_fn(state, cur)
        if chunks:
            metrics = RoundMetrics(*[
                np.concatenate([np.atleast_1d(getattr(c, f)) for c in chunks])
                for f in RoundMetrics._fields])
        else:                        # num_rounds == 0: empty, not None
            metrics = RoundMetrics(*[np.zeros((0,), np.float32)
                                     for _ in RoundMetrics._fields])
        return state, RunHistory(metrics, evals)

    def run_loop(self, state: FLState,
                 num_rounds: int) -> Tuple[FLState, RoundMetrics]:
        """The seed driver's pattern: one round at a time, reading the loss
        and the mean cosine back to the host after each."""
        tracer = get_tracer()
        out: List[RoundMetrics] = []
        for _ in range(num_rounds):
            state, m = self._round(state)
            float(m.loss)
            float(torch.mean(m.cosine))
            if tracer.enabled:
                tracer.settle(*tracer.sync_point(
                    tree_leaves(state.params)[0].device))
            self.stats.host_syncs += 2
            self.stats.rounds += 1
            out.append(m)
        return state, _to_host(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LiveRoundLoop:
    """The server half of a live cross-process round over a transport.

    Where ``RoundEngine`` loops over the clients in one process,
    ``LiveRoundLoop`` drives real client processes through a
    ``repro_torch.comm.transport.SocketServer``: broadcast the params frame,
    ``collect`` the uplink under the round deadline with backoff, retries
    and liveness, ACK each worker its delivered verdict, and aggregate on
    the server.

    The server step is the codec round's own (``fl.round.
    codec_server_step``: the round's frames decoded as one batch, the
    reconstructions, the masked mean × N/count, ``server_update``), with
    every transport outcome — timeout, corrupt frame, dead worker — mapped
    onto the ``delivered=False`` mask. Undelivered rows are zero
    placeholder frames whose decode the masked mean never reads. So the
    live loop is bitwise the in-process codec round on the same delivered
    pattern.

    ``participate_fn(round) -> (N,) bool`` drives partial participation
    (non-participants sit the round out; their EF freezes).
    ``on_round(record, report)`` fires after every round with the history
    record and the raw ``DeliveryReport``.
    """

    def __init__(self, server, strategy, codec, run, params, *,
                 policy: Optional[RetryPolicy] = None,
                 participate_fn=None, on_round=None):
        # comm sits beside fl: imported here
        from repro_torch.comm.codec import make_codec
        from repro_torch.configs.base import CompressorConfig

        self.server = server
        self.strategy = strategy
        self.codec = codec
        self.cfg = run
        self.policy = policy if policy is not None else run.retry_policy()
        self.participate_fn = participate_fn
        self.on_round = on_round
        self.params = tree_map(torch.clone, params)
        self.device = tree_leaves(params)[0].device
        self.history: List[Dict[str, Any]] = []
        # the downlink broadcast is the raw params frame (identity codec)
        self._down = make_codec(
            CompressorConfig(kind="identity", error_feedback=False), params)
        self._placeholder = np.zeros((codec.nbytes,), np.uint8)

    def _step(self, frames: np.ndarray, delivered: np.ndarray) -> None:
        bufs = torch.as_tensor(frames).to(self.device)
        self.params, _ = codec_server_step(
            self.codec, self.params, bufs, torch.as_tensor(delivered),
            self.cfg.fl.server_lr)
        _sync(self.device)

    def run(self, num_rounds: int, *, deadline_s: Optional[float] = None,
            policy: Optional[RetryPolicy] = None, ckpt_every: int = 0,
            ckpt_fn=None):
        """Drive ``num_rounds`` live rounds; returns the final params.
        Per-round records (wall clock, delivered mask, retries, byte
        buckets, dead set, reported losses) accumulate in ``history``.
        ``deadline_s``/``policy`` override the loop's configuration for
        these rounds only (a first round, in which every worker warms up,
        wants a generous window).

        ``ckpt_fn(loop, round)`` fires where ``(round + 1) % ckpt_every ==
        0``; round indices are absolute (``server.begin_round`` resumes
        numbering from a restored ledger), so a resumed loop checkpoints at
        the rounds the uninterrupted one does. The hook is expected to
        settle the server's EF bank (``wait_ef_bank``) before it
        snapshots."""
        N = self.cfg.fl.num_clients
        dl = self.cfg.round_deadline_s if deadline_s is None else deadline_s
        pol = self.policy if policy is None else policy
        tracer = get_tracer()
        meters = get_registry()
        for _ in range(num_rounds):
            r = self.server.begin_round()
            oh0 = (self.server.overhead_up, self.server.overhead_down)
            t0 = time.perf_counter()
            with tracer.span("round", round=r, deadline_s=dl) as round_sp:
                with tracer.span("round.encode", round=r,
                                 phase="encode") as enc_sp:
                    down = self._down.encode(self.params, round_idx=r)
                    down = down.cpu().numpy()
                    enc_sp.end(bytes=int(down.nbytes))
                part = (np.ones((N,), bool) if self.participate_fn is None
                        else np.asarray(self.participate_fn(r), bool))
                with tracer.span("round.broadcast", round=r,
                                 phase="broadcast"):
                    self.server.broadcast_round(r, down, part)
                live = np.zeros((N,), bool)
                live[self.server.live_workers()] = True
                with tracer.span("round.collect", round=r, phase="collect",
                                 deadline_s=dl) as col_sp:
                    rep = self.server.collect(
                        r, part & live, policy=pol, deadline_s=dl)
                    col_sp.end(delivered=int(rep.delivered.sum()),
                               retries=rep.retries)
                with tracer.span("round.ack", round=r, phase="ack"):
                    self.server.send_acks(r, rep.delivered)
                with tracer.span("round.aggregate", round=r,
                                 phase="aggregate"):
                    bufs = np.stack(
                        [np.asarray(f, np.uint8) if f is not None
                         else self._placeholder for f in rep.frames])
                    self._step(bufs, rep.delivered)
                dead = sorted(set(range(N))
                              - set(self.server.live_workers()))
                # one outcome tag per client per round: what the trace
                # report attributes stragglers, drops and deaths from
                for cid in range(N):
                    if not part[cid]:
                        outcome = "sat_out"
                    elif rep.delivered[cid]:
                        outcome = "delivered"
                    elif cid in dead:
                        outcome = "dead"
                    else:
                        outcome = "undelivered"
                    tracer.event("round.outcome", round=r, client=cid,
                                 outcome=outcome)
                round_sp.end(delivered=int(rep.delivered.sum()),
                             retries=rep.retries)
            wall_s = time.perf_counter() - t0
            meters.counter("loop.rounds").inc()
            meters.gauge("loop.round").set(r)
            meters.histogram("loop.round_wall_s").observe(wall_s)
            rec = {"round": r,
                   "wall_s": wall_s,
                   "participate": part,
                   "delivered": rep.delivered.copy(),
                   "retries": rep.retries,
                   "bytes_up": self.server.uplink.per_round[-1],
                   "bytes_down": self.server.downlink.per_round[-1],
                   "overhead_up": self.server.overhead_up - oh0[0],
                   "overhead_down": self.server.overhead_down - oh0[1],
                   "dead": dead,
                   "losses": self.server.pop_metrics(r)}
            self.history.append(rec)
            if self.on_round is not None:
                self.on_round(rec, rep)
            if ckpt_fn is not None and ckpt_every > 0 \
                    and (r + 1) % ckpt_every == 0:
                ckpt_fn(self, r)
        return self.params
