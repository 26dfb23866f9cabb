"""The client's 3SFC encode as a CUDA graph per client row
(``repro_torch.fl.encode_graph``).

On the CPU: the path chooser's routes to the eager encode, each with its
reason; the in-place server update, accumulate and EF write of the graph
path against today's out-of-place results; and the graph cache, through
a seam whose graphs rerun their body, over donated engine rounds held
bitwise to the eager ones (captures once per row, replays after that,
captures again when an address changes).

On a CUDA card only (skipped elsewhere): 3 donated rounds of a narrow
qwen1.5 LM and of the paper's MLP with real CUDA graphs, bitwise the
eager rounds in params, EF rows, messages, cosines, scales and
objectives, with N captures, N·2 replays, N eager encodes and the B1/B2
launch counts of the eager rounds. Needs no JAX:
``pytest --noconftest tests/test_torch_encode_graph.py`` runs it on the
card.
"""
import argparse
import contextlib
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import (CompressorConfig, FLConfig,
                                      get_smoke_config)
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.core.threesfc import init_syn
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl import encode_graph
from repro_torch.fl import round as round_mod
from repro_torch.fl.engine import RoundEngine, device_pools, vision_batcher
from repro_torch.fl.round import build_fl_round
from repro_torch.fl.server import server_update
from repro_torch.kernels import ef_update as ef_mod
from repro_torch.kernels import fused_cosine as fc_mod
from repro_torch.kernels import ops
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import VisionSpec, make_paper_model
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs import meters as meters_mod
from repro_torch.obs import trace as trace_mod

torch.set_num_threads(2)

N = 3
SPEC = VisionSpec("tiny", (4, 4, 1), 3)
THREESFC = dict(kind="threesfc", syn_steps=2, syn_lr=0.1)



class RerunBackend:
    """Graphs for the CPU. A capture runs its body once, standing for the
    capture and the replay that follows it; each later replay reruns the
    body on the tensors it captured and writes the results into the
    captured outputs, as a CUDA graph's fixed addresses would."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    @staticmethod
    def supports(device):
        return True

    @staticmethod
    def side(device):
        return contextlib.nullcontext()

    def capture(self, device, body):
        self.captures += 1
        outputs = body()
        return _RerunGraph(self, body, outputs), outputs


class _RerunGraph:
    def __init__(self, backend, body, outputs):
        self.backend, self.body, self.outputs = backend, body, outputs
        self.ran = True

    def replay(self):
        self.backend.replays += 1
        if self.ran:                 # the capture's own run
            self.ran = False
            return
        for dst, src in zip(flat.tree_leaves(self.outputs),
                            flat.tree_leaves(self.body())):
            dst.copy_(src)


@pytest.fixture
def traced(monkeypatch):
    """A process tracer that is on and a fresh registry, for the
    counters."""
    monkeypatch.setattr(trace_mod, "_GLOBAL", Tracer(enabled=True))
    reg = MetricsRegistry()
    monkeypatch.setattr(meters_mod, "_GLOBAL", reg)
    return reg


def _counters(reg):
    return {k[len("client.encode."):]: v
            for k, v in reg.snapshot()["counters"].items()
            if k.startswith("client.encode.")}


def _mlp_engine(kind=THREESFC, *, device=torch.device("cpu"), donate=True,
                backend=None, seed=0, **run_kw):
    """``kind`` on the tiny MLP: N=3 clients, K=2 steps of batch 4."""
    comp = CompressorConfig(**kind)
    model = make_paper_model("mlp", SPEC)
    strat = make_strategy(comp, loss_fn=model.syn_loss,
                          syn_spec=vision_syn_spec(SPEC, comp),
                          local_lr=0.05)
    rng = np.random.default_rng(seed)
    x = rng.random((120, 4, 4, 1), dtype=np.float32)
    y = rng.integers(0, 3, 120).astype(np.int32)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=seed, min_per_client=4)
    params = model.init(torch.Generator().manual_seed(seed))
    params = flat.tree_map(lambda p: p.to(device), params)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=2,
                                compressor=comp), **run_kw)
    codec = strat.wire_codec(params) if run.wire == "codec" else None
    rf = build_fl_round(model.loss, strat, run, codec=codec,
                        graph_backend=backend)
    engine = RoundEngine(rf, vision_batcher(x, y, device_pools(parts, device),
                                            2, 4), seed=seed, donate=donate)
    return engine, engine.init_state(params, N, strat), rf


def _bits(tree):
    return [t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
            for t in flat.tree_leaves(tree)]


def _same(a, b, what):
    assert _bits(a) == _bits(b), f"{what} differ"


# ---------------------------------------------------------------------------
# the path chooser
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _scope_hook():
    yield


EAGER_CASES = {
    "cpu": dict(backend=encode_graph.CudaGraphBackend()),
    "undonated": dict(donate=False),
    "faults": dict(drop_rate=0.3, participation_rate=0.7),
    "codec": dict(wire="codec"),
    "kind": dict(kind=dict(kind="fedsynth", syn_steps=2, syn_lr=0.1)),
    "no_ef": dict(kind=dict(THREESFC, error_feedback=False)),
    "scope_hooks": dict(hooks=True),
}


@pytest.mark.parametrize("reason", list(EAGER_CASES))
def test_chooser_routes_to_eager_with_its_reason(reason, traced,
                                                 monkeypatch):
    """Every round whose encode cannot be a graph runs today's eager
    encode: no capture, no side stream, and each encode counted eager
    with the reason."""
    kw = dict(EAGER_CASES[reason])
    if kw.pop("hooks", False):
        monkeypatch.setattr(round_mod, "SCOPE_HOOKS", [_scope_hook])
    backend = kw.pop("backend", None) or RerunBackend()
    eng, state, rf = _mlp_engine(backend=backend, **kw)
    state, ms = eng.run_block(state, 2)
    assert np.isfinite(ms.loss).all()
    assert _counters(traced) == {"eager": 2 * N, f"eager.{reason}": 2 * N}
    assert getattr(backend, "captures", 0) == 0
    assert rf.encode_graphs.msgs is None


def test_chooser_routes_dtensor_params_to_eager(tmp_path):
    """``DTensor`` params (tensor parallelism) come first: eager."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1,))
        params = {"w": distribute_tensor(torch.ones(4, 2), mesh,
                                         [Replicate()])}
        strat = make_strategy(CompressorConfig(**THREESFC),
                              loss_fn=lambda p, s: 0.0,
                              syn_spec=vision_syn_spec(SPEC, CompressorConfig(
                                  **THREESFC)))
        got = encode_graph.eager_reason(
            params, strat, RerunBackend(), donate=True, shardings=None,
            faulted=False, wired=False, hooks=False)
        assert got == "dtensor"
    finally:
        dist.destroy_process_group()


def test_chooser_engages_only_where_everything_holds():
    """The one route to the graph: a backend for the device, one process,
    donated, no faults or codec, 3SFC with EF, no scope hooks."""
    comp = CompressorConfig(**THREESFC)
    strat = make_strategy(comp, loss_fn=lambda p, s: 0.0,
                          syn_spec=vision_syn_spec(SPEC, comp))
    params = {"w": torch.ones(3)}
    base = dict(donate=True, shardings=None, faulted=False, wired=False,
                hooks=False)
    assert encode_graph.eager_reason(params, strat, RerunBackend(),
                                     **base) is None
    for knob, value, reason in (("shardings", object(), "shard_map"),
                                ("donate", False, "undonated"),
                                ("faulted", True, "faults"),
                                ("wired", True, "codec"),
                                ("hooks", True, "scope_hooks")):
        got = encode_graph.eager_reason(params, strat, RerunBackend(),
                                        **dict(base, **{knob: value}))
        assert got == reason, knob
    assert encode_graph.eager_reason(
        params, strat, encode_graph.CudaGraphBackend(), **base) == "cpu"


# ---------------------------------------------------------------------------
# the in-place writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_server_update_in_place_is_bitwise(dtype):
    """w^{t+1} written into w^t's own tensors is bitwise the out-of-place
    result, in the donated storage."""
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn((7, 5), generator=g).to(dtype),
              "b": torch.randn((9,), generator=g).to(dtype)}
    agg = {"a": torch.randn((7, 5), generator=g),
           "b": torch.randn((9,), generator=g).to(dtype)}
    want = server_update(params, agg, 0.37)
    ptrs = [t.data_ptr() for t in flat.tree_leaves(params)]
    got = server_update(params, agg, 0.37, out=params)
    assert got is params
    assert [t.data_ptr() for t in flat.tree_leaves(got)] == ptrs
    _same(got, want, "in-place server update")


def test_accumulate_and_ef_write_in_place_are_bitwise():
    """e_j += g is bitwise g + e; B2's route with ``out`` = u is bitwise
    the new buffer's; the strategy's ``encode_update`` writing the EF row
    in place equals ``step``; all in the donated row's storage."""
    comp = CompressorConfig(**THREESFC)
    model = make_paper_model("mlp", SPEC)
    strat = make_strategy(comp, loss_fn=model.syn_loss,
                          syn_spec=vision_syn_spec(SPEC, comp))
    params = model.init(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    grads = flat.tree_map(lambda p: torch.randn(p.shape, generator=g),
                          params)
    ef = flat.tree_map(lambda p: torch.randn((N, *p.shape), generator=g),
                       params)
    row = flat.tree_map(lambda e: e[1], ef)
    ptrs = [t.data_ptr() for t in flat.tree_leaves(row)]
    syn0 = init_syn(torch.Generator().manual_seed(4), strat.syn_spec)
    want_msg, want_ef, want_m = strat.step(syn0, grads, row, params)
    want_u = flat.tree_add(grads, row)
    flat.tree_map(lambda e, gi: e.add_(gi), row, grads)
    _same(row, want_u, "e += g against g + e")
    d = flat.tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    s = torch.tensor(0.3)
    want_b2 = ops.tree_ef_update(row, d, s)
    u_copy = flat.tree_map(torch.clone, row)
    got_b2 = ops.tree_ef_update(u_copy, d, s, out=u_copy)
    assert got_b2 is u_copy
    _same(got_b2, want_b2, "B2 in place")
    msg, e_new, m = strat.encode_update(syn0, row, row, params, ef_out=row)
    assert [t.data_ptr() for t in flat.tree_leaves(e_new)] == ptrs
    _same(e_new, want_ef, "EF row written in place")
    _same(msg, want_msg, "message")
    _same(tuple(m), tuple(want_m), "metrics")


# ---------------------------------------------------------------------------
# the graph cache, through the rerun seam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_graph_rounds_bitwise_the_eager_rounds(fused, traced):
    """Donated engine rounds on the graph path (the rerun seam) against
    the eager path: bitwise params, EF and metrics every round. Row j
    warms eagerly in round 1, is captured once in round 2 and replayed
    from then on; params moved to new tensors make every row capture
    again, and the rounds stay bitwise."""
    backend = RerunBackend()
    eng, state, rf = _mlp_engine(backend=backend, fused_decode=fused)
    ref_eng, ref, _ = _mlp_engine(
        backend=encode_graph.CudaGraphBackend(), fused_decode=fused)
    ptrs = [t.data_ptr() for t in flat.tree_leaves(state.params)]
    for r in range(3):
        state, m = eng.run_block(state, 1)
        ref, rm = ref_eng.run_block(ref, 1)
        _same(state.params, ref.params, f"round {r} params")
        _same(state.ef, ref.ef, f"round {r} EF")
        for f in ("loss", "cosine", "payload_floats", "update_norm"):
            assert getattr(m, f).tobytes() == getattr(rm, f).tobytes(), f
    assert [t.data_ptr() for t in flat.tree_leaves(state.params)] == ptrs
    assert (backend.captures, backend.replays) == (N, 2 * N)
    c = _counters(traced)
    assert (c["graph_captures"], c["graph_replays"]) == (N, 2 * N)
    assert c["eager.warmup"] == N and c["eager.cpu"] == 3 * N
    # an address changes: the params in new tensors
    state = state._replace(params=flat.tree_map(torch.clone, state.params))
    for r in range(3, 5):
        state, m = eng.run_block(state, 1)
        ref, rm = ref_eng.run_block(ref, 1)
        _same(state.params, ref.params, f"round {r} params")
        _same(state.ef, ref.ef, f"round {r} EF")
        assert m.cosine.tobytes() == rm.cosine.tobytes()
    assert (backend.captures, backend.replays) == (2 * N, 4 * N)
    c = _counters(traced)
    assert (c["graph_captures"], c["graph_replays"]) == (2 * N, 4 * N)
    assert c["eager"] - c["eager.cpu"] == N        # the warm-ups only


def test_failed_capture_runs_that_key_eagerly(traced):
    """A capture that raises leaves its key eager (counted
    ``capture_failed``), bitwise the same rounds, and is not retried
    while the key holds."""

    class Refusing(RerunBackend):
        def capture(self, device, body):
            self.captures += 1
            raise RuntimeError("no capture here")

    backend = Refusing()
    eng, state, _ = _mlp_engine(backend=backend)
    ref_eng, ref, _ = _mlp_engine(backend=encode_graph.CudaGraphBackend())
    with pytest.warns(RuntimeWarning, match="failed to capture"):
        for _ in range(3):
            state, _ = eng.run_block(state, 1)
            ref, _ = ref_eng.run_block(ref, 1)
    _same(state.params, ref.params, "params")
    _same(state.ef, ref.ef, "EF")
    assert backend.captures == N
    c = _counters(traced)
    assert c["eager.capture_failed"] == 2 * N and "graph_replays" not in c


# ---------------------------------------------------------------------------
# on the card: real CUDA graphs
# ---------------------------------------------------------------------------


def _recording(monkeypatch, log):
    """Wraps ``make_client_step`` so that every client step's message and
    metrics are cloned into ``log`` as they come."""
    real = round_mod.make_client_step

    def make(*a, **k):
        step = real(*a, **k)

        def rec(*sa, **sk):
            out = step(*sa, **sk)
            log.append((flat.tree_map(torch.clone, out.msg),
                        tuple(t.clone() for t in out.metrics)))
            return out
        return rec

    monkeypatch.setattr(round_mod, "make_client_step", make)


def _qwen_engine(device, fused, backend=None):
    from repro_torch.fl.engine import token_batcher
    from repro_torch.launch import train
    cfg = get_smoke_config("qwen1.5-0.5b")
    args = argparse.Namespace(clients=N, local_steps=1, lr=0.01, batch=2,
                              rounds=1, seed=0)
    comp = CompressorConfig(kind="threesfc", error_feedback=True,
                            syn_steps=1, syn_seq=4)
    model, strat, run = train.lm_setup(args, cfg, comp, 16)
    run = run.replace(fused_decode=fused)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16))
    rf = build_fl_round(model.loss, strat, run, graph_backend=backend)
    eng = RoundEngine(rf, token_batcher(toks, N, 1, 2, device=device),
                      seed=0)
    g = torch.Generator(device=device).manual_seed(0)
    return eng, eng.init_state(model.init(g), N, strat), rf


@pytest.fixture
def card():
    """The card, decided when the test runs; skips where none is
    visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (real CUDA graphs)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", ["qwen", "mlp"])
def test_card_graph_rounds_bitwise_the_eager_rounds(model, fused, card,
                                                    traced, monkeypatch):
    """3 donated rounds with the encode's CUDA graphs against 3 donated
    eager rounds (a no-op scope hook keeps the encode eager): bitwise the
    same params, EF rows, messages (the scales among them when fused),
    cosines and objectives; N captures, N·2 replays, N warm-up encodes;
    the B1/B2 launch counts of the eager rounds, so a capture adds
    none."""
    dev = card
    logs, states, launches = {}, {}, {}
    for path in ("graph", "eager"):
        logs[path] = []
        with monkeypatch.context() as mp:
            _recording(mp, logs[path])
            if path == "eager":
                mp.setattr(round_mod, "SCOPE_HOOKS", [_scope_hook])
            if model == "qwen":
                eng, state, _ = _qwen_engine(dev, fused)
            else:
                eng, state, _ = _mlp_engine(device=dev, fused_decode=fused)
            before = (fc_mod.LAUNCHES, ef_mod.LAUNCHES)
            for _ in range(3):
                state, _ = eng.run_block(state, 1)
            torch.cuda.synchronize()
            launches[path] = (fc_mod.LAUNCHES - before[0],
                              ef_mod.LAUNCHES - before[1])
            states[path] = state
    _same(states["graph"].params, states["eager"].params, "params")
    _same(states["graph"].ef, states["eager"].ef, "EF rows")
    assert len(logs["graph"]) == len(logs["eager"]) == 3 * N
    for k, (a, b) in enumerate(zip(logs["graph"], logs["eager"])):
        _same(a[0], b[0], f"message {k}")
        _same(a[1], b[1], f"cosine, floats and objective {k}")
    assert launches["graph"] == launches["eager"]
    assert launches["graph"][1] == 3 * N
    c = _counters(traced)
    assert (c["graph_captures"], c["graph_replays"]) == (N, 2 * N)
    assert c["eager.warmup"] == N
    assert c["eager.scope_hooks"] == 3 * N
