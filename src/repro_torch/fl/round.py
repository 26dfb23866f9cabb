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

The client body (``make_client_step``, with ``missed_ef`` for a message
that does not count) and the codec round's server step
(``codec_server_step``: reconstructions, ``masked_mean``,
``server_update``) are module functions: the socket transport's workers
(``repro_torch.launch.worker``) and its server loop
(``repro_torch.fl.engine.LiveRoundLoop``) run these same functions, so a
live round is bitwise the in-process one.

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

Each client's step runs inside ``client_scope()``: a profiler range named
``CLIENT_SCOPE`` (as the reference names its scope) and the hooks of
``SCOPE_HOOKS``, through which ``repro_torch.analysis.contracts`` records
what the step does (no collective, no host read of a tensor's value).
With ``donate=True`` (``RoundEngine``'s default) the round writes the new
EF rows into the input state's EF tensors instead of a second N×d tree.

The encode graph path (``repro_torch.fl.encode_graph``): where
``encode_graph.eager_reason`` finds nothing against it — CUDA params that
are plain tensors, one process, ``donate=True``, no faults, no codec, the
``threesfc`` kind with error feedback and no ``SCOPE_HOOKS`` active — each
client row's encode is one CUDA graph, warmed eagerly on the capture
stream in the row's first round, captured in its second and replayed from
then on. Its update u = g + e accumulates in place into the donated EF
row, where B2 also writes e'; its message goes into row j of an (N, ...)
message tree kept across rounds; and the server writes w^{t+1} into the
input state's params, so a donated round on this path consumes the
params too. The values are bitwise the eager round's. Everywhere else
(the CPU, tensor parallelism, the fan-out, faults, codec mode, the other
strategies, undonated calls, the contract recorder's and sync check's
hooks) the round runs the eager encode, unchanged.

Phase spans (``repro_torch.obs``): with the process tracer on, each
client's step opens ``client.train`` (local training) and
``client.encode`` (the strategy's step: accumulate, encode, EF), and the
round's server phase ``server.aggregate`` (the messages' decode through
the update's norm), each marked on the params' device; the caller's host
sync settles their device times (``RoundEngine.run_block``). They are
opened when the round runs, so a tracer turned on after the round was
built sees them; with it off each is the shared no-op span.

Tensor parallelism: when the state's params are ``DTensor``s on the
``model`` sub-mesh (``FLShardings.place_state`` on a mesh whose model axis
is larger than 1), the round runs in ``models.shard``'s context, each
client's batch enters replicated on that mesh, the per-leaf math runs on
the shards (the kernels on local shards, ``kernels.ops``), and the new
params and EF stay placed as they came; the metrics leave as plain
tensors. Codec mode does not combine with it (``NotImplementedError``).

Randomness: client ``i``'s encoder draws from a ``torch.Generator`` seeded
with ``fold_in(key, i)``, where ``key`` is the round's integer seed; the
round function's ``syn0`` argument replaces those draws with given initial
``D_syn`` (leading axis N) — the seam the parity tests use. The generator,
``syn0``, the codec's frame header and the fault masks take the global
client id; under ``'shard_map'`` the EF rows and the batch tree take the
rank's local one.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import CompressionStrategy, warn_deprecated_once
from repro_torch.core.threesfc import SynData
from repro_torch.fl import encode_graph
from repro_torch.fl import faults as faults_lib
from repro_torch.fl.client import local_train
from repro_torch.fl.server import aggregate, server_update
from repro_torch.models import shard
from repro_torch.obs import get_tracer

PyTree = Any

# The per-client local-train + encode region, named as the reference names
# its scope: a profiler range of this name wraps every client's step, so
# the card's traces label it, and ``in_client_scope()`` tells the contract
# recorder (``repro_torch.analysis.contracts``) that a call falls inside it.
CLIENT_SCOPE = "fl_client_local"
# context-manager factories entered around every client's step, inside the
# profiler range (the recorder and the card's sync check install theirs)
SCOPE_HOOKS: List[Callable[[], Any]] = []
_scope_depth = 0


def in_client_scope() -> bool:
    """Whether the caller runs inside a client's step."""
    return _scope_depth > 0


@contextlib.contextmanager
def client_scope():
    """The ``CLIENT_SCOPE`` region around one client's step."""
    global _scope_depth
    with torch.profiler.record_function(CLIENT_SCOPE), \
            contextlib.ExitStack() as hooks:
        for hook in SCOPE_HOOKS:
            hooks.enter_context(hook())
        _scope_depth += 1
        try:
            yield
        finally:
            _scope_depth -= 1

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


class ClientStep(NamedTuple):
    """One client's round body: its message (reconstruction tree, wire
    payload or codec frame), its residual when the message counts, its
    local update ``g`` and loss, and the compressor's metrics."""

    msg: Any
    ef: PyTree
    g: PyTree
    loss: torch.Tensor
    metrics: Any


def make_client_step(loss_fn: Callable[[PyTree, Dict], torch.Tensor],
                     strategy: CompressionStrategy, run: RunConfig, *,
                     codec=None) -> Callable[..., ClientStep]:
    """Client ``cid``'s body of round ``rnd``: K local SGD steps, then the
    strategy's EF-compressed message — a codec frame (``run.wire ==
    'codec'``), the wire payload (fused decode) or the reconstruction.
    The in-process round runs it for each of its clients and a socket
    worker (``repro_torch.launch.worker``) for its one; both then pick the
    residual: ``ClientStep.ef`` when the message counts, ``missed_ef``
    when it does not.

    Returns ``step(params, batches_i, ef_i, key_i, cid, rnd)``."""
    cfg: FLConfig = run.fl
    if run.wire == "codec":
        def encode(key_i, g, ef_i, params, cid, rnd):
            return strategy.wire_step(key_i, g, ef_i, params, codec=codec,
                                      round_idx=rnd, client_idx=cid)
    else:
        method = strategy.payload_step if run.fused_decode else strategy.step

        def encode(key_i, g, ef_i, params, cid, rnd):
            return method(key_i, g, ef_i, params)

    def step(params, batches_i, ef_i, key_i, cid: int, rnd: int, *,
             encode_fn=None) -> ClientStep:
        """``encode_fn`` stands in for the strategy's encode (the round's
        encode graph, ``fl.encode_graph``)."""
        tracer = get_tracer()
        dev = flat.tree_leaves(params)[0].device if tracer.enabled else None
        with tracer.span("client.train", device=dev, client=cid, round=rnd,
                         K=cfg.local_steps, num_micro=run.num_micro):
            g, loss = local_train(loss_fn, params, batches_i, cfg.local_lr,
                                  num_micro=run.num_micro)
        with tracer.span("client.encode", device=dev, client=cid, round=rnd):
            msg, ef_row, m = (encode_fn or encode)(key_i, g, ef_i, params,
                                                   cid, rnd)
        return ClientStep(msg, ef_row, g, loss, m)

    return step


def missed_ef(strategy: CompressionStrategy, out: ClientStep, ef_i: PyTree,
              participated: bool) -> PyTree:
    """The residual of a client whose message did not count: a skipped
    client's freezes; a dropped message leaves the whole update u = g + e
    in it (EF off: e stays)."""
    dropped = participated and strategy.cfg.error_feedback
    return strategy._accumulate(out.g, ef_i) if dropped else ef_i


def masked_mean(recons: PyTree, arrived: torch.Tensor,
                device) -> Tuple[PyTree, float]:
    """The masked aggregate over the leading client axis and its count:
    ``mean(where(arrived, x, 0)) · (N/count)``, which multiplies by
    exactly 1.0 when every client arrived (then it is bitwise the plain
    mean). ``arrived`` is a host (N,) bool tensor; rows it masks out are
    never read, so they may hold anything (a placeholder frame's
    decode)."""
    cnt = float(arrived.sum())
    ratio = _ratio(arrived.numel(), cnt)
    mask = arrived.to(device)
    agg = flat.tree_map(lambda x: torch.mean(torch.where(
        _bcast(mask, x), x, 0.0), dim=0) * ratio, recons)
    return agg, cnt


def server_messages(codec, msgs, params: PyTree, *, fused: bool) -> PyTree:
    """The round's (N, ...) messages as the server aggregates them: as
    they are (no codec), the decoded payloads (fused) or the
    reconstructions, a round's frames decoded as one batch."""
    if codec is None:
        return msgs
    if fused:
        return codec.decode_batch(msgs)
    return codec.recon_batch(msgs, params)


def codec_server_step(codec, params: PyTree, frames: torch.Tensor,
                      arrived: torch.Tensor,
                      server_lr: float) -> Tuple[PyTree, float]:
    """The server half of a codec round from its (N, nbytes) frames and the
    host mask of those that arrived: reconstructions, the masked mean,
    ``server_update``. The faulted codec round at ``staleness_max == 0``
    without weights computes the same, in the same order. Returns (new
    params, count)."""
    device = flat.tree_leaves(params)[0].device
    recons = server_messages(codec, frames, params, fused=False)
    agg, cnt = masked_mean(recons, arrived, device)
    return server_update(params, agg, server_lr), cnt


def build_fl_round(
    loss_fn: Callable[[PyTree, Dict], torch.Tensor],
    strategy: CompressionStrategy,
    run: RunConfig,
    *,
    codec=None,
    fault_schedule_fn=None,
    graph_backend=None,
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
    syn0=None, *, donate=False)`` takes the (N, K, B, ...) batch tree, the
    round's integer seed, optional aggregation weights and an optional
    per-client initial ``SynData`` (leading axis N). By default it returns
    a fresh state and writes none of the input state's tensors. With
    ``donate=True`` (what ``RoundEngine`` passes) it writes each client's
    new EF row into the input state's own EF tensors, which the returned
    state then holds: no second N×d tree. Client ``j`` reads its row
    before anything writes it and nothing reads it after, so the round is
    bitwise the undonated one; the input state is consumed: its EF is the
    new round's, and on the encode graph path (module docstring) so are
    its params, which take w^{t+1} in place. Under
    ``client_parallel='shard_map'`` the state's EF tree and the batch tree
    hold this rank's clients only, and each rank donates its own rows.

    ``graph_backend`` supplies the encode's CUDA graphs
    (``encode_graph.CudaGraphBackend`` by default; the tests' seam). The
    returned function carries its ``encode_graphs``
    (``encode_graph.EncodeGraphs``).
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
    client_step = make_client_step(loss_fn, strategy, run, codec=codec)
    wire_bytes = float(codec.nbytes) if wired else 0.0
    if run.client_parallel == "shard_map":
        shardings = run.shardings()
        clients = shardings.local_clients(N)
    else:
        shardings, clients = None, range(N)
    graphs = encode_graph.EncodeGraphs(strategy, len(clients), fused=fused,
                                       backend=graph_backend)

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
            agg, cnt = masked_mean(recons, now, device)
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
        In one process the message trees come stacked already (the round
        writes each into its row as it comes). Under shard_map one
        collective gathers them already stacked, and the server phase takes
        them as they come. Fused mode has no use for the clients' payload
        floats and leaves them out."""
        if shardings is None:
            return (msgs, torch.stack(losses), torch.stack(cos),
                    None if fused else torch.stack(floats))
        # imported here: DTensor's import (sympy, fx) takes seconds, and
        # a socket worker, which never shards, should not pay it
        from repro_torch.fl.sharding import all_gather_rows
        rows = [(m, l, c) if fused else (m, l, c, f)
                for m, l, c, f in zip(msgs, losses, cos, floats)]
        got = all_gather_rows(rows, shardings.group)
        return got[0], got[1], got[2], None if fused else got[3]

    def fl_round(state: FLState, client_batches: PyTree, key: int,
                 weights: Optional[torch.Tensor] = None,
                 syn0: Optional[SynData] = None, *, donate: bool = False
                 ) -> Tuple[FLState, RoundMetrics]:
        tp = shard.mesh_of(state.params)
        if tp is None:
            return run_round(state, client_batches, key, weights, syn0,
                             donate, None)
        if wired:
            raise NotImplementedError(
                "wire='codec' with tensor parallelism (a model axis larger "
                "than 1): no entry of the reference reaches it")
        with shard.context(tp):
            new, rm = run_round(state, client_batches, key, weights, syn0,
                                donate, tp)
        return new, rm._replace(**{f: shard.leave(getattr(rm, f))
                                   for f in ("loss", "cosine",
                                             "payload_floats",
                                             "update_norm")})

    def run_round(state: FLState, client_batches: PyTree, key: int,
                  weights: Optional[torch.Tensor], syn0: Optional[SynData],
                  donate: bool, tp) -> Tuple[FLState, RoundMetrics]:
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
        reason = encode_graph.eager_reason(
            params, strategy, graphs.backend, donate=donate,
            shardings=shardings, faulted=faulted, wired=wired,
            hooks=bool(SCOPE_HOOKS))
        graphed = reason is None
        if not graphed:
            graphs.count_eager(reason, len(clients))
        new_ef = (state.ef if donate
                  else flat.tree_map(torch.empty_like, state.ef))
        msgs, losses, cos, floats = [], [], [], []
        # in one process a message tree goes straight into its row of the
        # (N, ...) tensors, so the round never holds the N trees twice
        stack_rows = shardings is None and not wired
        for j, i in enumerate(clients):
            # i: the global client id; j: its row in this rank's EF rows
            # and batch tree
            ef_i = flat.tree_map(lambda e: e[j], state.ef)
            batches_i = shard.enter(
                flat.tree_map(lambda x: x[j], client_batches), tp)
            key_i = (SynData(*[t[i] for t in syn0]) if syn0 is not None
                     else client_generator(key, i, device))
            # every client trains and encodes, scheduled or not, as in the
            # reference (its cosine is reported either way)
            with client_scope():
                out = client_step(
                    params, batches_i, ef_i, key_i, i, state.round,
                    encode_fn=(functools.partial(graphs.encode, j)
                               if graphed else None))
            ef_row = out.ef
            if faulted and not (part[i] and deliv[i]):
                ef_row = missed_ef(strategy, out, ef_i, part[i])
            if graphed:
                # the encode wrote its residual into ef_i and its message
                # into row j of the kept graphs.msgs, in place
                msgs = graphs.msgs
            else:
                # the new residual row goes straight into the (N, ...)
                # tensors (donated: into row j of the input's, which ef_i
                # views and nothing reads after this)
                flat.tree_map(lambda dst, src: dst[j].copy_(src), new_ef,
                              ef_row)
                if stack_rows:
                    if j == 0:
                        msgs = flat.tree_map(
                            lambda m: m.new_empty((N, *m.shape)), out.msg)
                    flat.tree_map(lambda dst, src: dst[j].copy_(src), msgs,
                                  out.msg)
                else:
                    msgs.append(out.msg)
            losses.append(out.loss)
            cos.append(out.metrics.cosine)
            floats.append(out.metrics.payload_floats)
            # this client's trees go before the next one trains
            del out, ef_row
        msgs, losses, cos, floats = stack_clients(msgs, losses, cos, floats)
        if faulted:
            # loss over participants only: mean × N/count, exactly 1.0 when
            # everyone participates
            kept = [l if p else torch.zeros_like(l)
                    for l, p in zip(losses, part)]
            loss = torch.mean(torch.stack(kept)) * _ratio(N, sum(part))
        else:
            loss = torch.mean(losses)
        # the server phase, from the messages to the update's norm
        with get_tracer().span("server.aggregate", device=device,
                               round=state.round):
            # (N, ...) messages: payloads (fused) or reconstructions
            batch = server_messages(codec if wired else None, msgs, params,
                                    fused=fused)
            buf, buf_w = state.buf, state.buf_w
            if fused:
                pf = torch.tensor(strategy.payload_floats(params),
                                  dtype=torch.float32, device=device)
                if faulted:
                    # zero undelivered payloads inside the batched aggregate
                    # (S is 0 here by RunConfig), then renormalize over
                    # arrivals
                    now = sched.arrives_now
                    arrivals = float(now.sum())
                    agg = strategy.server_aggregate(
                        params, strategy.mask_payloads(
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
            if graphed:
                # the graphs read the params where they lie: w^{t+1} goes
                # into w^t's tensors, which the donated state gives up
                new_params = server_update(params, agg, cfg.server_lr,
                                           out=params)
            else:
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

    # the encode graphs, for a look from outside (tests, the card's checks)
    fl_round.encode_graphs = graphs
    return fl_round


# ---------------------------------------------------------------------------
# deprecated shim: the old 10-knob factory over the new pipeline
# ---------------------------------------------------------------------------


def make_fl_round(
    loss_fn: Callable[[PyTree, Dict], torch.Tensor],
    compressor,
    cfg: FLConfig,
    *,
    num_micro: int = 1,
    fused_decode: bool = False,
    syn_loss_fn: Callable = None,
    syn_spec=None,
    client_parallel: str = "vmap",
    mesh=None,
    wire: str = "float",
    codec=None,
) -> Callable[..., Tuple[FLState, RoundMetrics]]:
    """Deprecated: build a ``RunConfig`` and call ``build_fl_round``.

    ``compressor`` may be a ``TreeCompressor`` (its strategy is used) or a
    ``CompressionStrategy`` directly. The legacy ``syn_loss_fn``/``syn_spec``
    pair is required with ``fused_decode`` for signature compatibility but
    the strategy's own hooks (identical by construction) do the work.
    """
    warn_deprecated_once(
        "make_fl_round",
        "repro_torch.fl.round.build_fl_round(loss_fn, strategy, "
        "RunConfig(...))")
    if fused_decode and (syn_loss_fn is None or syn_spec is None):
        raise ValueError("fused_decode needs the 3SFC syn_loss_fn + syn_spec")
    strategy = getattr(compressor, "strategy", compressor)
    run = RunConfig(fl=cfg, client_parallel=client_parallel, wire=wire,
                    fused_decode=fused_decode, num_micro=num_micro,
                    mesh=mesh)
    return build_fl_round(loss_fn, strategy, run, codec=codec)


# convenience alias used in docs/examples
fl_round = make_fl_round
