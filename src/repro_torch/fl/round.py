"""One federated round, end to end.

``build_fl_round(loss_fn, strategy, run)`` composes the round function from
three phases, each parameterized by the ``RunConfig`` and the
``CompressionStrategy``:

  1. **client phase** — every client runs K local SGD steps, then the
     strategy EF-compresses its accumulated update into a *message*: the
     reconstruction tree (float mode), the raw wire payload (fused mode)
     or a framed ``uint8`` codec buffer (codec mode, ``run.wire ==
     'codec'``). The JAX package vmaps this over clients; here it is a
     loop.
  2. **boundary** — the messages are stacked on a leading client axis; in
     codec mode the server decodes the round's N frames as one batch: into
     payloads when fused (``Codec.decode_batch``, the reference's
     ``jax.vmap(codec.decode)``), else into reconstructions
     (``Codec.recon_batch``); one B3b launch for signSGD, frame by frame
     for the other codecs.
  3. **server phase** — the default path averages the per-client
     reconstructions (``fl.server``); a strategy declaring
     ``supports_fused_aggregate`` (3SFC) aggregates straight from the
     batched payloads (``strategy.server_aggregate``, one backward).

Codec mode serializes each client's payload with the codec from
``repro_torch.comm.make_codec`` (or ``strategy.wire_codec``); EF uses the
codec's dequantized view, so wherever the codec is lossless the round
equals the float-mode round, and ``RoundMetrics.wire_bytes_up`` is the
measured frame size (0 in float mode).

Randomness: client ``i``'s encoder draws from a ``torch.Generator`` seeded
with ``fold_in(key, i)``, where ``key`` is the round's integer seed; the
round function's ``syn0`` argument replaces those draws with given initial
``D_syn`` (leading axis N) — the seam the parity tests use.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import CompressionStrategy
from repro_torch.core.threesfc import SynData
from repro_torch.fl.client import local_train
from repro_torch.fl.server import aggregate, server_update

PyTree = Any

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A new 63-bit seed from ``seed`` and integers — the port's counterpart
    of ``jax.random.fold_in`` on integer seeds (its streams differ from
    JAX's)."""
    x = _splitmix64(seed & _MASK64)
    for d in data:
        x = _splitmix64(x ^ _splitmix64(d & _MASK64))
    return x >> 1


def client_generator(key: int, client: int,
                     device: torch.device) -> torch.Generator:
    """The generator client ``client``'s encoder draws from this round."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(key, client))
    return gen


class FLState(NamedTuple):
    params: PyTree          # global model w^t
    ef: PyTree              # per-client EF residuals, leading axis N
    round: int              # absolute round counter


class RoundMetrics(NamedTuple):
    loss: torch.Tensor      # mean local training loss
    cosine: torch.Tensor    # per-client compression efficiency (N,)
    payload_floats: torch.Tensor
    update_norm: torch.Tensor
    wire_bytes_up: float = 0.0
    arrivals: float = -1.0


def fl_init(params: PyTree, num_clients: int,
            strategy: Optional[CompressionStrategy] = None) -> FLState:
    """Fresh round state; the EF residual comes from the strategy when one
    is given (zeros f32 mirroring params otherwise — the same default)."""
    if strategy is not None:
        ef1 = strategy.init_ef_state(params)
    else:
        ef1 = flat.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    ef = flat.tree_map(
        lambda e: e.unsqueeze(0).expand(num_clients, *e.shape).clone(), ef1)
    return FLState(params, ef, 0)


def _check_codec(run: RunConfig, strategy: CompressionStrategy,
                 codec) -> None:
    """Validate the (wire, codec) pair for codec mode."""
    if run.wire == "float":
        return
    if codec is None:
        raise ValueError("wire='codec' requires a codec "
                         "(see repro_torch.comm.make_codec)")
    if codec.kind != strategy.cfg.kind:
        raise ValueError(f"codec kind {codec.kind!r} does not match "
                         f"compressor kind {strategy.cfg.kind!r}")
    codec.check_round_wire()


def build_fl_round(
    loss_fn: Callable[[PyTree, Dict], torch.Tensor],
    strategy: CompressionStrategy,
    run: RunConfig,
    *,
    codec=None,
) -> Callable[..., Tuple[FLState, RoundMetrics]]:
    """The round builder over (strategy × float/codec wire × float/fused
    decode).

    ``run.fused_decode`` requires ``strategy.supports_fused_aggregate``:
    for 3SFC, since every ĝ_i is evaluated at the same w^t (Eq. 10),

        G(ĝ_1..ĝ_N) = ∇_w (1/N) Σ_i s_i F(D_syn,i, w^t),

    so the server runs one backward over the gathered (D_syn, s) payloads.
    EF stays exact because each client updates its residual locally.

    The returned ``fl_round(state, client_batches, key, weights=None,
    syn0=None)`` takes the (N, K, B, ...) batch tree, the round's integer
    seed, optional aggregation weights and an optional per-client initial
    ``SynData`` (leading axis N). It returns a fresh state: the input
    state's tensors are not written.
    """
    cfg: FLConfig = run.fl
    fused = run.fused_decode
    wired = run.wire == "codec"
    N = cfg.num_clients
    if fused and not strategy.supports_fused_aggregate:
        raise ValueError(
            f"fused_decode requires a strategy with "
            f"supports_fused_aggregate; {strategy.cfg.kind!r} has none")
    _check_codec(run, strategy, codec)
    if wired:
        def encode(key_i, g, ef_i, params, cid, rnd):
            return strategy.wire_step(key_i, g, ef_i, params, codec=codec,
                                      round_idx=rnd, client_idx=cid)
    else:
        step = strategy.payload_step if fused else strategy.step

        def encode(key_i, g, ef_i, params, cid, rnd):
            return step(key_i, g, ef_i, params)
    wire_bytes = float(codec.nbytes) if wired else 0.0

    def fl_round(state: FLState, client_batches: PyTree, key: int,
                 weights: Optional[torch.Tensor] = None,
                 syn0: Optional[SynData] = None
                 ) -> Tuple[FLState, RoundMetrics]:
        params = state.params
        device = flat.tree_leaves(params)[0].device
        new_ef = flat.tree_map(torch.empty_like, state.ef)
        msgs, losses, cos, floats = [], [], [], []
        for i in range(N):
            ef_i = flat.tree_map(lambda e: e[i], state.ef)
            batches_i = flat.tree_map(lambda x: x[i], client_batches)
            key_i = (SynData(*[t[i] for t in syn0]) if syn0 is not None
                     else client_generator(key, i, device))
            g, loss = local_train(loss_fn, params, batches_i, cfg.local_lr,
                                  num_micro=run.num_micro)
            msg, ef_row, m = encode(key_i, g, ef_i, params, i, state.round)
            # the new residual row goes straight into the (N, ...) tensors
            flat.tree_map(lambda dst, src: dst[i].copy_(src), new_ef, ef_row)
            msgs.append(msg)
            losses.append(loss)
            cos.append(m.cosine)
            floats.append(m.payload_floats)
        # (N, ...) messages: payloads (fused) or reconstructions
        if not wired:
            batch = flat.tree_stack(msgs)
        elif fused:
            batch = codec.decode_batch(msgs)
        else:
            batch = codec.recon_batch(msgs, params)
        if fused:
            agg = strategy.server_aggregate(params, batch)
            pf = torch.tensor(strategy.payload_floats(params),
                              dtype=torch.float32, device=device)
        else:
            agg = aggregate(batch, weights)
            pf = torch.mean(torch.stack(floats))
        new_params = server_update(params, agg, cfg.server_lr)
        rm = RoundMetrics(
            loss=torch.mean(torch.stack(losses)),
            cosine=torch.stack(cos),
            payload_floats=pf,
            update_norm=flat.tree_norm(agg),
            wire_bytes_up=wire_bytes,
            arrivals=float(N),
        )
        return FLState(new_params, new_ef, state.round + 1), rm

    return fl_round
