"""Port parity for the FL round (``repro_torch.fl.round``), the engine and
the trainer entry point, on the CPU.

The reference draws params, batches and every client's ``syn0``; the port
runs the same rounds from the same numbers (N=4, K=3, B=16 as in
tests/test_fl_round.py) and must end where the reference ends within the
bounds the reference holds its own fused-vs-float comparison to
(tests/test_fused_decode.py): params rtol 1e-4 / atol 1e-6, EF rtol 1e-4 /
atol 1e-5 — the two differ only in summation order.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.run import RunConfig as JRunConfig
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.data.partition import dirichlet_partition as jpartition
from repro.data.synthetic import make_class_image_dataset as jdataset
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models.build import vision_syn_spec as jsyn_spec
from repro.models.cnn import MNIST_SPEC as JMNIST
from repro.models.cnn import make_paper_model as jmodel
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.strategy import make_strategy
from repro_torch.core.threesfc import SynData
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl.engine import RoundEngine, device_pools, vision_batcher
from repro_torch.fl.round import build_fl_round, fl_init
from repro_torch.launch import train
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import MNIST_SPEC, make_mlp

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, K, BATCH, LR = 4, 3, 16, 0.05
ROUNDS, SYN_STEPS = 3, 3
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(got, want, **tol):
    for g, w in zip(jax.tree.leaves(to_numpy(got)), jax.tree.leaves(_np(want))):
        np.testing.assert_allclose(g, w, **tol)


@pytest.fixture(scope="module")
def world():
    model = jmodel("mlp", JMNIST)
    params = model.init(jax.random.PRNGKey(0))
    ds = jdataset(jax.random.PRNGKey(1), 600, (28, 28, 1), 10)
    rng = np.random.default_rng(0)
    bx = np.stack([ds.x[rng.choice(600, (K, BATCH))] for _ in range(N)])
    by = np.stack([ds.y[rng.choice(600, (K, BATCH))] for _ in range(N)])
    return {"model": model, "params": params,
            "batches": {"x": jnp.asarray(bx), "y": jnp.asarray(by)},
            "tparams": params_from_numpy(_np(params), CPU),
            "tbatches": params_from_numpy({"x": bx, "y": by}, CPU)}


def _rounds(world, kind, fused, rounds):
    """``rounds`` rounds on both sides; returns per-round metrics and the
    final states. Each reference round key feeds its clients' syn0 to the
    port, so both encoders start every client from the same D_syn."""
    ccfg = dict(kind=kind, syn_steps=SYN_STEPS, syn_lr=0.1,
                error_feedback=kind != "identity")
    jcomp = JCompressorConfig(**ccfg)
    jspec = jsyn_spec(JMNIST, jcomp)
    jstrat = jmake_strategy(jcomp, loss_fn=world["model"].syn_loss,
                            syn_spec=jspec, local_lr=LR)
    jround = jax.jit(jbuild_round(world["model"].loss, jstrat, JRunConfig(
        fl=JFLConfig(num_clients=N, local_steps=K, local_lr=LR,
                     compressor=jcomp), fused_decode=fused)))
    comp = CompressorConfig(**ccfg)
    tmodel = make_mlp(MNIST_SPEC)
    tstrat = make_strategy(comp, loss_fn=tmodel.syn_loss,
                           syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                           local_lr=LR)
    tround = build_fl_round(tmodel.loss, tstrat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=comp), fused_decode=fused))

    js = jfl_init(world["params"], N)
    ts = fl_init(world["tparams"], N, tstrat)
    key = jax.random.PRNGKey(3)
    out = []
    for _ in range(rounds):
        key, kr = jax.random.split(key)
        syns = jax.vmap(lambda k: jthreesfc.init_syn(k, jspec))(
            jax.random.split(kr, N))
        js, jm = jround(js, world["batches"], kr)
        ts, tm = tround(ts, world["tbatches"], 0,
                        syn0=SynData(*[torch.from_numpy(np.array(t))
                                       for t in syns]))
        out.append((jm, tm))
    return out, js, ts


@pytest.fixture(scope="module")
def threesfc_float(world):
    return _rounds(world, "threesfc", False, ROUNDS)


@pytest.fixture(scope="module")
def threesfc_fused(world):
    return _rounds(world, "threesfc", True, ROUNDS)


@pytest.mark.parametrize("mode", ["float", "fused"])
def test_threesfc_ef_rounds_match_reference(request, mode):
    metrics, js, ts = request.getfixturevalue(f"threesfc_{mode}")
    assert ts.round == int(js.round) == ROUNDS
    _assert_close(ts.params, js.params, **PARAM_TOL)
    _assert_close(ts.ef, js.ef, **EF_TOL)


@pytest.mark.parametrize("mode", ["float", "fused"])
def test_threesfc_round_metrics_match_reference(request, mode):
    metrics, _, _ = request.getfixturevalue(f"threesfc_{mode}")
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(tm.cosine.numpy(), np.asarray(jm.cosine),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm.payload_floats),
                                   float(jm.payload_floats))
        np.testing.assert_allclose(float(tm.update_norm),
                                   float(jm.update_norm), rtol=1e-4)


def test_fused_decode_matches_float_decode(threesfc_float, threesfc_fused):
    """The port's fused decode is the float decode up to summation order."""
    _, _, t_float = threesfc_float
    _, _, t_fused = threesfc_fused
    _assert_close(t_fused.params, to_numpy(t_float.params), **PARAM_TOL)
    _assert_close(t_fused.ef, to_numpy(t_float.ef), **EF_TOL)


def test_round_leaves_its_input_state_unchanged(world):
    comp = CompressorConfig(kind="threesfc", syn_steps=1)
    tmodel = make_mlp(MNIST_SPEC)
    strat = make_strategy(comp, loss_fn=tmodel.syn_loss,
                          syn_spec=vision_syn_spec(MNIST_SPEC, comp))
    rf = build_fl_round(tmodel.loss, strat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, compressor=comp)))
    s0 = fl_init(world["tparams"], N, strat)
    before = to_numpy(s0)
    s1, _ = rf(s0, world["tbatches"], 7)
    s2, _ = rf(s0, world["tbatches"], 7)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(to_numpy(s0))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(to_numpy(s1)), jax.tree.leaves(to_numpy(s2))):
        np.testing.assert_array_equal(a, b)


def test_fedavg_round_matches_reference(world):
    metrics, js, ts = _rounds(world, "identity", False, 1)
    _assert_close(ts.params, js.params, rtol=1e-5, atol=1e-6)
    (jm, tm), = metrics
    np.testing.assert_allclose(tm.cosine.numpy(), 1.0)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)


@pytest.mark.parametrize("alpha,clients,seed", [(0.3, 8, 1), (0.5, 10, 0),
                                                (0.05, 16, 3)])
def test_dirichlet_partition_bitwise(alpha, clients, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 2000)
    got = dirichlet_partition(labels, clients, alpha=alpha, seed=seed,
                              min_per_client=16)
    want = jpartition(labels, clients, alpha=alpha, seed=seed,
                      min_per_client=16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _small_engine(seed=0):
    comp = CompressorConfig(kind="threesfc", syn_steps=2, syn_lr=0.1)
    tmodel = make_mlp(MNIST_SPEC)
    strat = make_strategy(comp, loss_fn=tmodel.syn_loss,
                          syn_spec=vision_syn_spec(MNIST_SPEC, comp))
    rng = np.random.default_rng(seed)
    x = rng.random((120, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 120).astype(np.int32)
    parts = dirichlet_partition(y, 3, alpha=0.5, seed=seed, min_per_client=4)
    engine = RoundEngine(
        build_fl_round(tmodel.loss, strat, RunConfig(
            fl=FLConfig(num_clients=3, local_steps=2, compressor=comp))),
        vision_batcher(x, y, device_pools(parts, CPU), 2, 4), seed=seed)
    params = tmodel.init(torch.Generator().manual_seed(seed))
    return engine, engine.init_state(params, 3, strat)


def test_eval_cadence_invariance():
    """Blocks [3] and [2, 1] give bitwise the same trajectory, and the
    per-round loop agrees with both."""
    e1, s1 = _small_engine()
    e2, s2 = _small_engine()
    e3, s3 = _small_engine()
    a, ha = e1.run(s1, 3, eval_every=0)
    seen = []
    b, hb = e2.run(s2, 3, eval_every=2,
                   eval_fn=lambda st, m, r: seen.append((r, len(m.loss))))
    c, mc = e3.run_loop(s3, 3)
    assert seen == [(2, 2), (3, 1)]
    for x, y, z in zip(jax.tree.leaves(to_numpy(a)),
                       jax.tree.leaves(to_numpy(b)),
                       jax.tree.leaves(to_numpy(c))):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    np.testing.assert_array_equal(ha.metrics.loss, hb.metrics.loss)
    np.testing.assert_array_equal(ha.metrics.cosine, mc.cosine)
    assert ha.metrics.cosine.shape == (3, 3)


def test_engine_batches_are_a_function_of_seed_round_client():
    e1, _ = _small_engine()
    e2, _ = _small_engine()
    b1 = e1._batch_fn(e1._data_seed, 5)
    b2 = e2._batch_fn(e2._data_seed, 5)
    np.testing.assert_array_equal(b1["x"].numpy(), b2["x"].numpy())
    assert tuple(b1["x"].shape) == (3, 2, 4, 28, 28, 1)
    b3 = e1._batch_fn(e1._data_seed, 6)
    assert not np.array_equal(b1["y"].numpy(), b3["y"].numpy())


def test_runconfig_validation():
    fl = FLConfig()
    for kw in ({"client_parallel": "shard_map"},
               {"transport": "socket"}, {"drop_rate": 0.1},
               {"participation_rate": 0.5}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            RunConfig(fl=fl, **kw)
    codec = RunConfig(fl=fl, wire="codec", wire_policy="fp16").to_json()
    assert codec["wire"] == "codec" and codec["wire_policy"] == "fp16"
    for kw in ({"client_parallel": "pmap"}, {"wire": "bytes"},
               {"num_micro": 0}, {"straggler_rate": 0.5},
               {"fused_decode": True, "staleness_max": 1}):
        with pytest.raises(ValueError):
            RunConfig(fl=fl, **kw)
    assert RunConfig(fl=fl).to_json()["fl"]["num_clients"] == fl.num_clients


def test_trainer_writes_reference_metric_keys(tmp_path):
    out = tmp_path / "run"
    train.main(["--model", "mlp", "--dataset", "mnist", "--compressor",
                "threesfc", "--rounds", "2", "--clients", "3",
                "--local-steps", "2", "--batch", "8", "--train-size", "200",
                "--eval-every", "1", "--device", "cpu", "--out", str(out)])
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["round"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"round", "loss", "acc", "cos", "payload_floats",
                          "elapsed_s"}
        assert np.isfinite(r["loss"]) and np.isfinite(r["cos"])
        assert r["payload_floats"] == 795.0
    cfg = json.load(open(os.path.join(out, "run_config.json")))
    assert cfg["device"] == "cpu" and cfg["fl"]["num_clients"] == 3
