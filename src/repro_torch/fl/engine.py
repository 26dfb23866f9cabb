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

Sharded fan-out: with ``RoundEngine(..., shardings=FLShardings)``
(``repro_torch.fl.sharding``) every rank runs the same engine; its state
holds the EF rows of the rank's own clients (``init_state`` places it), and
its batcher, given the rank's client range (``clients=``), draws only
those clients' batches. A batch is a pure function of ``(seed, round,
client)``, so each client's batch is the one the single-process engine
draws for it.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.fl.round import FLState, RoundMetrics, fl_init, fold_in

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
    ``shardings`` (the round built with ``client_parallel='shard_map'``)
    the state holds this rank's EF rows."""

    def __init__(self, round_fn: RoundFn, batch_fn: BatchFn, *,
                 seed: int = 0, shardings=None):
        self._data_seed = fold_in(seed, _DATA_FOLD)
        self._round_seed = fold_in(seed, _ROUND_FOLD)
        self._round_fn = round_fn
        self._batch_fn = batch_fn
        self._shardings = shardings
        self.stats = EngineStats()

    def init_state(self, params: PyTree, num_clients: int,
                   strategy=None, *, staleness_max: int = 0) -> FLState:
        """``fl_init`` on a copy of ``params``, so the caller's tensors are
        never the state's, placed by the engine's shardings when it has
        them; pass ``staleness_max=run.staleness_max`` when the round was
        built with staleness."""
        state = fl_init(tree_map(torch.clone, params), num_clients, strategy,
                        staleness_max=staleness_max)
        if self._shardings is not None:
            state = self._shardings.place_state(state)
        return state

    def _round(self, state: FLState) -> Tuple[FLState, RoundMetrics]:
        batches = self._batch_fn(self._data_seed, state.round)
        key = fold_in(self._round_seed, state.round)
        self.stats.dispatches += 1
        return self._round_fn(state, batches, key)

    def run_block(self, state: FLState,
                  length: int) -> Tuple[FLState, RoundMetrics]:
        """``length`` rounds; their metrics come back to the host at the end
        of the block."""
        ms = []
        for _ in range(length):
            state, m = self._round(state)
            ms.append(m)
        self.stats.host_syncs += 1
        self.stats.rounds += length
        return state, _to_host(ms)

    def run(self, state: FLState, num_rounds: int, *, eval_every: int = 0,
            eval_fn: Optional[Callable[[FLState, RoundMetrics, int], Any]]
            = None) -> Tuple[FLState, RunHistory]:
        """Blocks of ``eval_every`` rounds (plus a remainder block), with
        ``eval_fn(state, block_metrics, rounds_done)`` called at each eval
        boundary ((r+1) % eval_every == 0, plus the final round). Blocks
        end at multiples of ``eval_every`` of the absolute round counter."""
        r0 = state.round
        target = r0 + num_rounds
        chunks: List[RoundMetrics] = []
        evals: List[Tuple[int, Any]] = []
        cur = r0
        while cur < target:
            nxt = ((cur // eval_every + 1) * eval_every if eval_every > 0
                   else target)
            nxt = min(nxt, target)
            state, ms = self.run_block(state, nxt - cur)
            cur = nxt
            chunks.append(ms)
            if eval_fn is not None and (
                    cur == target or (eval_every > 0 and cur % eval_every == 0)):
                evals.append((cur - r0, eval_fn(state, ms, cur - r0)))
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
        out: List[RoundMetrics] = []
        for _ in range(num_rounds):
            state, m = self._round(state)
            float(m.loss)
            float(torch.mean(m.cosine))
            self.stats.host_syncs += 2
            self.stats.rounds += 1
            out.append(m)
        return state, _to_host(out)
