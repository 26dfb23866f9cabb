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
from repro_torch.core.strategy import make_strategy
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.engine import RoundEngine, device_pools, vision_batcher
from repro_torch.fl.round import build_fl_round
from repro_torch.fl.server import aggregate
from repro_torch.models.cnn import VisionSpec, make_paper_model

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


def _engine(seed=0):
    """FedAvg on the tiny MLP: N=3 clients, K=2 steps of batch 4."""
    comp = CompressorConfig(kind="identity", error_feedback=False)
    model = make_paper_model("mlp", SPEC)
    strat = make_strategy(comp)
    rng = np.random.default_rng(seed)
    x = rng.random((120, 4, 4, 1), dtype=np.float32)
    y = rng.integers(0, 3, 120).astype(np.int32)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=seed, min_per_client=4)
    engine = RoundEngine(
        build_fl_round(model.loss, strat, RunConfig(
            fl=FLConfig(num_clients=N, local_steps=2, compressor=comp))),
        vision_batcher(x, y, device_pools(parts, CPU), 2, 4), seed=seed)
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
