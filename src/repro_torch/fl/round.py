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

Fan-out (``run.client_parallel``): ``'vmap'`` loops over all N clients in
one process. ``'shard_map'`` (requires ``run.mesh``; ``repro_torch.fl.
sharding``) runs on every rank of the mesh: the rank loops over its own
block of clients only, reading and writing its EF rows (``state.ef`` holds
just those, as ``FLShardings.place_state`` leaves it, and so does the
batch tree), then ONE collective per round (``all_gather_rows``) gathers,
in client order, every client's message, loss and cosine (and payload
floats outside fused mode) — never the EF rows. The server phase then runs
on every rank, the same code in the same order over the same gathered
values as the single-process round, so the two agree bitwise. As in the
reference (whose boundary is ``all_gather``-then-reduce, never a
``psum``), the aggregate is never all-reduced: a reduction's combine order
would differ from the single-process mean.

Faults (``repro_torch.fl.faults``): with any fault knob set, or with a
``fault_schedule_fn``, the round reads the round's host ``FaultSchedule``.
Every client still trains and encodes; the schedule picks each EF row (a
skipped client's residual freezes, a dropped payload leaves ``e' = u``),
the loss is the mean over participants, and the aggregate renormalizes
over the weight that arrived, late payloads banked in the ``FLState``
staleness ring buffer and applied k rounds later at weight 1/(1+k). The
masked aggregate keeps the reference's algebra, so under the null
schedule it is bitwise the unfaulted round.

Codec mode serializes each client's payload with the codec from
``repro_torch.comm.make_codec`` (or ``strategy.wire_codec``); EF uses the
codec's dequantized view, so wherever the codec is lossless the round
equals the float-mode round, and ``RoundMetrics.wire_bytes_up`` is the
measured frame size (0 in float mode).

Randomness: client ``i``'s encoder draws from a ``torch.Generator`` seeded
with ``fold_in(key, i)``, where ``key`` is the round's integer seed; the
round function's ``syn0`` argument replaces those draws with given initial
``D_syn`` (leading axis N) — the seam the parity tests use. The generator,
``syn0``, the codec's frame header and the fault masks take the global
client id; under ``'shard_map'`` the EF rows and the batch tree take the
rank's local one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import CompressionStrategy
from repro_torch.core.threesfc import SynData
from repro_torch.fl import faults as faults_lib
from repro_torch.fl import sharding as sharding_lib
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
    # staleness ring buffer (repro_torch.fl.faults): per params leaf an
    # (S, *shape) bank of weighted in-flight reconstructions and the (S,)
    # arrived-weight accumulator; None whenever staleness_max == 0
    buf: PyTree = None
    buf_w: Optional[torch.Tensor] = None


class RoundMetrics(NamedTuple):
    loss: torch.Tensor      # mean local training loss (participants only)
    cosine: torch.Tensor    # per-client compression efficiency (N,)
    payload_floats: torch.Tensor
    update_norm: torch.Tensor
    wire_bytes_up: float = 0.0
    # total aggregation weight that arrived this round: N when healthy,
    # the renormalization denominator under faults
    arrivals: float = -1.0


def fl_init(params: PyTree, num_clients: int,
            strategy: Optional[CompressionStrategy] = None, *,
            staleness_max: int = 0) -> FLState:
    """Fresh round state; the EF residual comes from the strategy when one
    is given (zeros f32 mirroring params otherwise — the same default).
    ``staleness_max > 0`` attaches the zeroed staleness ring buffer."""
    if strategy is not None:
        ef1 = strategy.init_ef_state(params)
    else:
        ef1 = flat.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    ef = flat.tree_map(
        lambda e: e.unsqueeze(0).expand(num_clients, *e.shape).clone(), ef1)
    buf, buf_w = faults_lib.init_stale_buffer(params, staleness_max)
    return FLState(params, ef, 0, buf, buf_w)


def _ratio(n: int, count: float) -> float:
    """``N / count`` in f32 (0.0 when nothing arrived), as a Python float:
    exactly 1.0 when everyone did."""
    if count <= 0:
        return 0.0
    return float(np.float32(n) / np.float32(count))


def _bcast(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


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
    fault_schedule_fn=None,
) -> Callable[..., Tuple[FLState, RoundMetrics]]:
    """The round builder over (strategy × float/codec wire × float/fused
    decode × faults).

    ``run.fused_decode`` requires ``strategy.supports_fused_aggregate``:
    for 3SFC, since every ĝ_i is evaluated at the same w^t (Eq. 10),

        G(ĝ_1..ĝ_N) = ∇_w (1/N) Σ_i s_i F(D_syn,i, w^t),

    so the server runs one backward over the gathered (D_syn, s) payloads.
    EF stays exact because each client updates its residual locally.

    ``run.has_faults`` switches in the masked fault pipeline;
    ``fault_schedule_fn(round_idx, num_clients) -> FaultSchedule``
    overrides the config's schedule and forces the masked pipeline even on
    a zero-fault config (the seam the tests use to drive the null schedule
    and hand-written fault patterns). Injected delays must respect
    ``run.staleness_max``.

    The returned ``fl_round(state, client_batches, key, weights=None,
    syn0=None)`` takes the (N, K, B, ...) batch tree, the round's integer
    seed, optional aggregation weights and an optional per-client initial
    ``SynData`` (leading axis N). It returns a fresh state: the input
    state's tensors are not written. Under ``client_parallel='shard_map'``
    the state's EF tree and the batch tree hold this rank's clients only.
    """
    cfg: FLConfig = run.fl
    fused = run.fused_decode
    wired = run.wire == "codec"
    faulted = run.has_faults or fault_schedule_fn is not None
    N = cfg.num_clients
    S = run.staleness_max
    if fused and not strategy.supports_fused_aggregate:
        raise ValueError(
            f"fused_decode requires a strategy with "
            f"supports_fused_aggregate; {strategy.cfg.kind!r} has none")
    if faulted and fused and (type(strategy).mask_payloads
                              is CompressionStrategy.mask_payloads):
        raise ValueError(
            f"fused_decode under faults requires strategy "
            f"{strategy.cfg.kind!r} to implement mask_payloads "
            f"(weighting the batched wire payloads)")
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
    if run.client_parallel == "shard_map":
        shardings = run.shardings()
        clients = shardings.local_clients(N)
    else:
        shardings, clients = None, range(N)

    def schedule(round_idx: int) -> faults_lib.FaultSchedule:
        if fault_schedule_fn is not None:
            return fault_schedule_fn(round_idx, N)
        return faults_lib.fault_schedule(
            run.fault_seed, round_idx, N,
            participation_rate=run.participation_rate,
            drop_rate=run.drop_rate, straggler_rate=run.straggler_rate,
            staleness_max=S)

    def faulted_aggregate(state: FLState, recons, sched, weights, device):
        """Masked, weighted aggregation and the staleness buffer's turnover:
        ``(agg, arrivals, buf, buf_w)``. Unweighted without staleness it is
        ``mean(where(now, x, 0)) · (N/count)``, which multiplies by exactly
        1.0 under the null schedule."""
        now = sched.arrives_now
        if S == 0 and weights is None:
            cnt = float(now.sum())
            ratio = _ratio(N, cnt)
            mask = now.to(device)
            agg = flat.tree_map(lambda x: torch.mean(torch.where(
                _bcast(mask, x), x, 0.0), dim=0) * ratio, recons)
            return agg, cnt, state.buf, state.buf_w
        # one copy of the round's masks and weights to the device
        m = torch.stack([now.to(torch.float32),
                         sched.arrives_late.to(torch.float32),
                         sched.weight]).to(device)
        base_w = m[2] if weights is None else m[2] * weights
        w_now = torch.where(m[0] > 0, base_w, 0.0)

        def fresh(x):
            return torch.sum(_bcast(w_now, x) * x, dim=0)

        if S == 0:
            num = flat.tree_map(fresh, recons)
            den = torch.sum(w_now)
            buf, buf_w = state.buf, state.buf_w
        else:
            w_late = torch.where(m[1] > 0, base_w, 0.0)
            mature, mature_w, buf, buf_w = faults_lib.consume_and_bank(
                state.buf, state.buf_w, state.round, sched.delay, w_late,
                recons)
            num = flat.tree_map(lambda x, mt: fresh(x) + mt, recons, mature)
            den = torch.sum(w_now) + mature_w
        inv = torch.where(den > 0, 1.0 / den, 0.0)
        return flat.tree_map(lambda x: x * inv, num), den, buf, buf_w

    def stack_clients(msgs, losses, cos, floats):
        """Every client's record, in client order, each field stacked on a
        leading (N, ...) client axis: the messages (trees, or codec frames
        as one (N, nbytes) array), the losses, cosines and payload floats.
        Under shard_map one collective gathers them already stacked, and
        the server phase takes them as they come. Fused mode has no use for
        the clients' payload floats and leaves them out."""
        if shardings is None:
            return (msgs if wired else flat.tree_stack(msgs),
                    torch.stack(losses), torch.stack(cos),
                    None if fused else torch.stack(floats))
        rows = [(m, l, c) if fused else (m, l, c, f)
                for m, l, c, f in zip(msgs, losses, cos, floats)]
        got = sharding_lib.all_gather_rows(rows, shardings.group)
        return got[0], got[1], got[2], None if fused else got[3]

    def fl_round(state: FLState, client_batches: PyTree, key: int,
                 weights: Optional[torch.Tensor] = None,
                 syn0: Optional[SynData] = None
                 ) -> Tuple[FLState, RoundMetrics]:
        params = state.params
        device = flat.tree_leaves(params)[0].device
        if faulted:
            if S > 0 and state.buf_w is None:
                raise ValueError(
                    "staleness_max > 0 requires an FLState carrying the "
                    "staleness buffer — init with fl_init(..., "
                    "staleness_max=run.staleness_max)")
            sched = schedule(state.round)
            part = sched.participate.tolist()
            deliv = sched.delivered.tolist()
        if (shardings is not None
                and flat.tree_leaves(state.ef)[0].shape[0] != len(clients)):
            raise ValueError(
                f"a shard_map round takes this rank's {len(clients)} EF "
                f"rows (FLShardings.place_state), got "
                f"{flat.tree_leaves(state.ef)[0].shape[0]}")
        new_ef = flat.tree_map(torch.empty_like, state.ef)
        msgs, losses, cos, floats = [], [], [], []
        for j, i in enumerate(clients):
            # i: the global client id; j: its row in this rank's EF rows
            # and batch tree
            ef_i = flat.tree_map(lambda e: e[j], state.ef)
            batches_i = flat.tree_map(lambda x: x[j], client_batches)
            key_i = (SynData(*[t[i] for t in syn0]) if syn0 is not None
                     else client_generator(key, i, device))
            # every client trains and encodes, scheduled or not, as in the
            # reference (its cosine is reported either way)
            g, loss = local_train(loss_fn, params, batches_i, cfg.local_lr,
                                  num_micro=run.num_micro)
            msg, ef_row, m = encode(key_i, g, ef_i, params, i, state.round)
            if faulted and not (part[i] and deliv[i]):
                # a skipped client's residual freezes; a dropped payload
                # leaves the whole update u = g + e in it (EF off: e stays)
                dropped = part[i] and strategy.cfg.error_feedback
                ef_row = strategy._accumulate(g, ef_i) if dropped else ef_i
            # the new residual row goes straight into the (N, ...) tensors
            flat.tree_map(lambda dst, src: dst[j].copy_(src), new_ef, ef_row)
            msgs.append(msg)
            losses.append(loss)
            cos.append(m.cosine)
            floats.append(m.payload_floats)
        msgs, losses, cos, floats = stack_clients(msgs, losses, cos, floats)
        if faulted:
            # loss over participants only: mean × N/count, exactly 1.0 when
            # everyone participates
            kept = [l if p else torch.zeros_like(l)
                    for l, p in zip(losses, part)]
            loss = torch.mean(torch.stack(kept)) * _ratio(N, sum(part))
        else:
            loss = torch.mean(losses)
        # (N, ...) messages: payloads (fused) or reconstructions
        if not wired:
            batch = msgs
        elif fused:
            batch = codec.decode_batch(msgs)
        else:
            batch = codec.recon_batch(msgs, params)
        buf, buf_w = state.buf, state.buf_w
        if fused:
            pf = torch.tensor(strategy.payload_floats(params),
                              dtype=torch.float32, device=device)
            if faulted:
                # zero undelivered payloads inside the batched aggregate (S
                # is 0 here by RunConfig), then renormalize over arrivals
                now = sched.arrives_now
                arrivals = float(now.sum())
                agg = strategy.server_aggregate(params, strategy.mask_payloads(
                    batch, now.to(torch.float32).to(device)))
                agg = flat.tree_scale(agg, _ratio(N, arrivals))
            else:
                agg = strategy.server_aggregate(params, batch)
                arrivals = float(N)
        else:
            pf = torch.mean(floats)
            if faulted:
                agg, arrivals, buf, buf_w = faulted_aggregate(
                    state, batch, sched, weights, device)
            else:
                agg = aggregate(batch, weights)
                arrivals = float(N)
        new_params = server_update(params, agg, cfg.server_lr)
        rm = RoundMetrics(
            loss=loss,
            cosine=cos,
            payload_floats=pf,
            update_norm=flat.tree_norm(agg),
            wire_bytes_up=wire_bytes,
            arrivals=arrivals,
        )
        return FLState(new_params, new_ef, state.round + 1, buf, buf_w), rm

    return fl_round
