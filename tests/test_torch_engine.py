"""Port mirrors of the reference's engine and server tests
(tests/test_engine.py, tests/test_fl_round.py), on the CPU.

``aggregate`` is held to the reference's on the same numpy inputs; the
engine's device pools, zero-round runs and ``EngineStats`` keep the
reference's behaviour. ``EngineStats.dispatches`` counts round-function
calls, one per round here, where the reference's scanned block is one
dispatch: that assertion is the port's own count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.partition import dirichlet_partition as jpartition
from repro.fl.server import aggregate as jaggregate
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.engine import (ClientPools, RoundEngine, device_pools,
                                   token_batcher, vision_batcher)
from repro_torch.fl.round import build_fl_round
from repro_torch.fl.server import aggregate
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import VisionSpec, make_paper_model

from _torch_fanout import assert_check, run_ranks

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 3
SPEC = VisionSpec("tiny", (4, 4, 1), 3)


def test_weighted_aggregation():
    recons = {"w": torch.stack([torch.ones((3,)), 3 * torch.ones((3,))])}
    out = aggregate(recons, weights=torch.tensor([1.0, 3.0]))
    np.testing.assert_allclose(out["w"].numpy(), 2.5 * np.ones(3))
    out = aggregate(recons)
    np.testing.assert_allclose(out["w"].numpy(), 2.0 * np.ones(3))


@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_matches_reference(weighted):
    """The port's G over the client axis, mean or |D_i|-weighted, equals
    the reference's on the same inputs within one f32 rounding per add."""
    rng = np.random.default_rng(4)
    recons = {"a": rng.standard_normal((5, 7, 3)).astype(np.float32),
              "b": rng.standard_normal((5, 11)).astype(np.float32)}
    w = rng.random(5).astype(np.float32) * 10 if weighted else None
    got = aggregate({k: torch.from_numpy(v) for k, v in recons.items()},
                    None if w is None else torch.from_numpy(w))
    want = jaggregate({k: jnp.asarray(v) for k, v in recons.items()},
                      None if w is None else jnp.asarray(w))
    for k in recons:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


# the reference's engine kinds (tests/test_engine.py)
KINDS = {
    "fedavg": dict(kind="identity", error_feedback=False),
    "dgc": dict(kind="topk", keep_ratio=0.05),
    "signsgd": dict(kind="signsgd"),
    "stc": dict(kind="stc", keep_ratio=0.05),
    "threesfc": dict(kind="threesfc", syn_steps=2, syn_lr=0.1),
}
# every registered kind: the engine kinds and the two without a wire format
ALL_KINDS = {**KINDS, "randk": dict(kind="randk", keep_ratio=0.05),
             "fedsynth": dict(kind="fedsynth", syn_steps=2, syn_lr=0.1)}


def _engine(seed=0, kind="fedavg", donate=True):
    """``kind`` (FedAvg by default) on the tiny MLP: N=3 clients, K=2 steps
    of batch 4, the engine donating unless told not to."""
    comp = CompressorConfig(**ALL_KINDS[kind])
    model = make_paper_model("mlp", SPEC)
    strat = make_strategy(comp, loss_fn=model.syn_loss,
                          syn_spec=vision_syn_spec(SPEC, comp),
                          local_lr=0.05)
    rng = np.random.default_rng(seed)
    x = rng.random((120, 4, 4, 1), dtype=np.float32)
    y = rng.integers(0, 3, 120).astype(np.int32)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=seed, min_per_client=4)
    engine = RoundEngine(
        build_fl_round(model.loss, strat, RunConfig(
            fl=FLConfig(num_clients=N, local_steps=2, compressor=comp))),
        vision_batcher(x, y, device_pools(parts, CPU), 2, 4), seed=seed,
        donate=donate)
    params = model.init(torch.Generator().manual_seed(seed))
    return engine, engine.init_state(params, N, strat)


def test_engine_stats_accounting():
    """One host sync per block and two per round in the loop, as in the
    reference; one dispatch (round-function call) per round."""
    eng, state = _engine()
    state, _ = eng.run_block(state, 3)
    assert eng.stats.host_syncs == 1 and eng.stats.rounds == 3
    assert eng.stats.dispatches == 3
    assert eng.stats.per_round() == {"dispatches_per_round": 1.0,
                                     "host_syncs_per_round": 1 / 3}
    eng2, state2 = _engine()
    eng2.run_loop(state2, 3)
    assert eng2.stats.dispatches == 3 and eng2.stats.host_syncs == 6
    assert eng2.stats.rounds == 3


def test_run_zero_rounds_returns_empty_metrics():
    eng, state = _engine()
    state, hist = eng.run(state, 0, eval_every=2)
    assert hist.metrics.loss.shape == (0,)
    assert hist.evals == [] and eng.stats.dispatches == 0
    assert state.round == 0


def test_device_pools_padding_never_sampled():
    """Padded pool entries are unreachable through the real batcher: every
    gathered row belongs to the client's own partition. Each dataset row
    encodes its own index in x, so the batch shows which rows were read."""
    n = 200
    x = np.broadcast_to(np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1),
                        (n, 2, 2, 1)).copy()
    y = np.random.default_rng(0).integers(0, 10, n).astype(np.int32)
    parts = dirichlet_partition(y, 5, alpha=0.3, seed=2, min_per_client=4)
    for got, want in zip(parts, jpartition(y, 5, alpha=0.3, seed=2,
                                           min_per_client=4)):
        np.testing.assert_array_equal(got, want)
    bf = vision_batcher(x, y, device_pools(parts, CPU), 3, 6)
    for rnd in range(4):
        batch = bf(9, rnd)
        rows = batch["x"].numpy()[..., 0, 0, 0].astype(np.int64)  # (5,3,6)
        for i, pool in enumerate(parts):
            assert np.isin(rows[i], pool).all(), \
                f"client {i} sampled rows outside its pool at round {rnd}"
        np.testing.assert_array_equal(batch["y"].numpy(), y[rows])


def test_device_pools_zero_sample_client_clamped():
    """An empty Dirichlet part gets size 1 over its zero index row: the
    degenerate client resamples dataset row 0."""
    n = 60
    x = np.broadcast_to(np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1),
                        (n, 2, 2, 1)).copy()
    y = (np.arange(n) % 10).astype(np.int32)
    parts = [np.arange(20), np.array([], dtype=np.int64), np.arange(20, 60)]
    pools = device_pools(parts, CPU)
    assert pools.size.tolist() == [20, 1, 40]
    assert int(pools.index[1].sum()) == 0
    bf = vision_batcher(x, y, pools, local_steps=2, local_batch=4)
    rows = bf(0, 0)["x"].numpy()[..., 0, 0, 0].astype(np.int64)
    np.testing.assert_array_equal(rows[1], np.zeros((2, 4)))
    assert np.isin(rows[0], parts[0]).all()
    assert np.isin(rows[2], parts[2]).all()
    # all-empty partition: still a valid (clamped) pool
    pools2 = device_pools([np.array([], dtype=np.int64)] * 2, CPU)
    assert tuple(pools2.index.shape) == (2, 1)
    assert pools2.size.tolist() == [1, 1]


def _bits(tree) -> list:
    return [t.numpy().tobytes() for t in flat.tree_leaves(tree)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_bit_exact_vs_python_loop(kind):
    """Mirror of tests/test_engine.py: a block of 3 rounds (``run_block``,
    one metrics fetch) and 3 rounds one at a time (``run_loop``, two
    scalar syncs each) give bitwise the same params, EF and per-round
    metrics."""
    eng, state = _engine(kind=kind)
    s_block, mb = eng.run_block(state, 3)
    eng2, state2 = _engine(kind=kind)
    s_loop, ml = eng2.run_loop(state2, 3)
    assert _bits(s_block.params) == _bits(s_loop.params), f"{kind} params"
    assert _bits(s_block.ef) == _bits(s_loop.ef), f"{kind} ef"
    assert s_block.round == s_loop.round == 3
    for f in ("loss", "cosine", "payload_floats", "update_norm"):
        assert getattr(mb, f).tobytes() == getattr(ml, f).tobytes(), \
            f"{kind} metric {f} not bit-exact"


def test_run_blocks_match_eval_cadence():
    """engine.run: metrics cover every round, evals land on the block ends
    (every eval_every rounds plus the final round)."""
    eng, state = _engine()
    state, hist = eng.run(state, 5, eval_every=2,
                          eval_fn=lambda st, ms, r: (st.round, len(ms.loss)))
    assert hist.metrics.loss.shape == (5,)
    assert hist.metrics.cosine.shape == (5, N)
    assert [r for r, _ in hist.evals] == [2, 4, 5]
    assert [v for _, v in hist.evals] == [(2, 2), (4, 2), (5, 1)]


def test_run_handles_nonpositive_eval_every():
    """eval_every <= 0 means 'no eval cadence': one block for everything —
    one host sync (the reference's one scanned dispatch; the port calls
    the round function once per round)."""
    eng, state = _engine()
    state, hist = eng.run(state, 3, eval_every=0)
    assert hist.metrics.loss.shape == (3,)
    assert eng.stats.host_syncs == 1 and eng.stats.dispatches == 3
    assert hist.evals == []


def test_batchers_draw_a_client_range():
    """A rank's batcher (``clients=``, beside its pool rows) draws exactly
    the rows the whole batcher draws for those clients."""
    n = 120
    rng = np.random.default_rng(5)
    x = rng.random((n, 4, 4, 1), dtype=np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    parts = dirichlet_partition(y, 4, alpha=0.5, seed=1, min_per_client=4)
    pools = device_pools(parts, CPU)
    whole = vision_batcher(x, y, pools, 2, 4)(7, 3)
    part = ClientPools(pools.index[2:4].clone(), pools.size[2:4].clone())
    mine = vision_batcher(x, y, part, 2, 4, clients=range(2, 4))(7, 3)
    for k in ("x", "y"):
        assert torch.equal(mine[k], whole[k][2:4])
    with pytest.raises(ValueError, match="client ids"):
        vision_batcher(x, y, part, 2, 4, clients=range(3))
    toks = np.arange(50 * 7, dtype=np.int32).reshape(50, 7) % 13
    whole = token_batcher(toks, 4, 2, 3, extras={"frames": (5,)})(7, 3)
    mine = token_batcher(toks, 4, 2, 3, extras={"frames": (5,)},
                         clients=range(1, 3))(7, 3)
    assert torch.equal(mine["tokens"], whole["tokens"][1:3])
    assert tuple(mine["frames"].shape) == (2, 2, 3, 5)


@pytest.mark.transport(timeout=300)
def test_donation_safe_under_mesh(tmp_path):
    """Mirror of tests/test_engine.py's check under an installed mesh: on 2
    gloo ranks with ``shardings``, for every registered kind, the donating
    engine writes each round's EF into the rank's own EF rows in place,
    never writes the params it was handed or the caller's, and its rounds
    are bitwise the undonated engine's."""
    assert_check(run_ranks("engine", 2, tmp_path, timeout=240),
                 "donation_safe_under_mesh")


def _storages(tree) -> list:
    return [t.untyped_storage().data_ptr() for t in flat.tree_leaves(tree)]


def test_every_kind_is_pinned():
    """ALL_KINDS covers every kind the package registers (other test files
    register toy kinds in the same process)."""
    from repro_torch.core.strategy import STRATEGIES
    builtin = sorted(k for k, cls in STRATEGIES.items()
                     if cls.__module__ == "repro_torch.core.strategy")
    assert sorted(c["kind"] for c in ALL_KINDS.values()) == builtin


@pytest.mark.parametrize("kind", list(ALL_KINDS))
def test_donated_block_bit_exact_vs_undonated_loop(kind):
    """A donating engine's block of 3 rounds against an undonated engine's
    3 rounds one at a time: bitwise the same params, EF and per-round
    metrics, and the donated EF never leaves the storage init_state
    gave it."""
    eng, state = _engine(kind=kind)
    assert eng.donate                    # the reference's default
    storages = _storages(state.ef)
    s_block, mb = eng.run_block(state, 3)
    assert _storages(s_block.ef) == storages, f"{kind}: EF moved"
    eng2, state2 = _engine(kind=kind, donate=False)
    before = _bits(state2.ef)
    s_loop, ml = eng2.run_loop(state2, 3)
    assert _bits(state2.ef) == before, f"{kind}: undonated EF written"
    assert _bits(s_block.params) == _bits(s_loop.params), f"{kind} params"
    assert _bits(s_block.ef) == _bits(s_loop.ef), f"{kind} ef"
    assert s_block.round == s_loop.round == 3
    for f in ("loss", "cosine", "payload_floats", "update_norm"):
        assert getattr(mb, f).tobytes() == getattr(ml, f).tobytes(), \
            f"{kind} metric {f} not bit-exact"


def test_donation_consumes_state_and_caller_params_survive():
    """Mirror of tests/test_engine.py: the donated state is consumed (its
    EF tensors are the returned state's, holding the new round's values,
    and the engine refuses it), the caller's params — copied by
    init_state — are never written, and the returned state keeps
    working."""
    comp = CompressorConfig(**KINDS["stc"])
    model = make_paper_model("mlp", SPEC)
    params = model.init(torch.Generator().manual_seed(0))
    kept = _bits(params)
    eng, state = _engine(kind="stc")
    old_ef = flat.tree_leaves(state.ef)
    state2, _ = eng.run_block(state, 2)
    assert all(a is b for a, b in zip(old_ef, flat.tree_leaves(state2.ef)))
    assert any(bool(t.abs().sum() > 0) for t in old_ef)   # EF is live
    with pytest.raises(RuntimeError, match="donated"):
        eng.run_block(state, 1)
    assert _bits(params) == kept
    state3, ms = eng.run_block(state2, 2)
    assert np.isfinite(ms.loss).all() and state3.round == 4
    # the caller's own tree is never the state's
    eng_c, _ = _engine(kind="stc")
    st = eng_c.init_state(params, N, make_strategy(comp))
    eng_c.run_block(st, 1)
    assert _bits(params) == kept
