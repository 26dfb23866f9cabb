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
from repro.fl import client as jclient
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
from repro_torch.core import flat
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_class_image_dataset
from repro_torch.fl import client
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


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_microbatched_grad_matches(world, dtype):
    """Mirror of tests/test_fl_round.py::test_microbatched_grad_matches, and
    the same client against the reference at f32 and at bf16. The
    microbatch accumulator starts from f32 zeros on both sides, so the
    grads are f32 for bf16 parameters too. At bf16 the two frameworks'
    bf16 matmuls round apart, so each slice's grads may differ: the mean
    of the slices is held, element by element, within the mean of the
    slices' own gaps (plus four f32 roundings), a bound that accumulating
    in bf16 (the fault) falls outside in every leaf; and the update of one
    local step is held to one bf16 ulp at its leaf's largest local
    weight."""
    jparams, tparams = world["params"], world["tparams"]
    jb = jax.tree.map(lambda x: x[0], world["batches"])
    tb = {k: v[0] for k, v in world["tbatches"].items()}
    if dtype == "bf16":
        jparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
        tparams = flat.tree_map(lambda p: p.to(torch.bfloat16), tparams)
        jb = {**jb, "x": jb["x"].astype(jnp.bfloat16)}
        tb = {**tb, "x": tb["x"].to(torch.bfloat16)}
    jmodel_, tmodel = world["model"], make_mlp(MNIST_SPEC)
    g1, l1 = client.local_train(tmodel.loss, tparams, tb, 0.05, num_micro=1)
    g4, l4 = client.local_train(tmodel.loss, tparams, tb, 0.05, num_micro=4)
    if dtype == "f32":
        np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
        _assert_close(g1, to_numpy(g4), rtol=2e-4, atol=1e-6)

    step_j = jax.tree.map(lambda x: x[0], jb)
    step_t = {k: v[0] for k, v in tb.items()}
    jv, jg = jclient._grad_microbatched(jmodel_.loss, jparams, step_j, 4)
    tv, tg = client._grad_microbatched(tmodel.loss, tparams, step_t, 4)
    for a, b in zip(jax.tree.leaves(jg), flat.tree_leaves(tg)):
        assert a.dtype == jnp.float32 and b.dtype == torch.float32
    assert tv.dtype == torch.float32 and jv.dtype == jnp.float32
    if dtype == "f32":
        jg4, _ = jclient.local_train(jmodel_.loss, jparams, jb, 0.05,
                                     num_micro=4)
        _assert_close(tg, jg, rtol=1e-4, atol=1e-6)
        _assert_close(g4, jg4, rtol=1e-4, atol=1e-6)
        return
    # each slice's grads on both sides: their gaps bound the mean's, and the
    # mean accumulated in bf16 (the fault) falls outside that bound
    mb = step_t["x"].shape[0] // 4
    gaps, bf16_acc = [], None
    for i in range(4):
        _, jgi = jax.value_and_grad(jmodel_.loss)(
            jparams, jax.tree.map(lambda x: x[i * mb:(i + 1) * mb], step_j))
        _, tgi = client._value_and_grad(
            tmodel.loss, tparams,
            {k: v[i * mb:(i + 1) * mb] for k, v in step_t.items()})
        gaps.append([np.abs(np.asarray(a, np.float32) - b.float().numpy())
                     for a, b in zip(jax.tree.leaves(jgi),
                                     flat.tree_leaves(tgi))])
        bf16_acc = tgi if bf16_acc is None else flat.tree_add(bf16_acc, tgi)
    bf16_acc = flat.tree_scale(bf16_acc, 0.25)
    for leaf, (want, got, fault) in enumerate(zip(
            jax.tree.leaves(jg), flat.tree_leaves(tg),
            flat.tree_leaves(bf16_acc))):
        want = np.asarray(want)
        bound = (np.mean([g[leaf] for g in gaps], axis=0)
                 + 2.0 ** -22 * np.abs(want).max())
        assert np.all(np.abs(got.numpy() - want) <= bound), leaf
        assert np.any(np.abs(fault.float().numpy() - want) > bound), leaf
    # one local step: over K steps the two bf16 forwards' roundings compound
    one_j = jax.tree.map(lambda x: x[:1], jb)
    one_t = {k: v[:1] for k, v in tb.items()}
    jg1, _ = jclient.local_train(jmodel_.loss, jparams, one_j, 0.05,
                                 num_micro=4)
    tg1, _ = client.local_train(tmodel.loss, tparams, one_t, 0.05,
                                num_micro=4)
    for got, want, w0 in zip(flat.tree_leaves(tg1), jax.tree.leaves(jg1),
                             jax.tree.leaves(jparams)):
        want = np.asarray(want)
        w_local = np.asarray(w0, np.float32) - want
        assert got.dtype == torch.float32
        assert np.all(np.abs(got.numpy() - want)
                      <= _bf16_ulp(np.abs(w_local).max()))


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
    with pytest.raises(NotImplementedError, match="not ported yet"):
        RunConfig(fl=fl, transport="socket")
    # the shard_map fan-out is ported: it needs a mesh
    # (tests/test_torch_sharding.py holds it on real meshes)
    with pytest.raises(ValueError, match="explicit mesh"):
        RunConfig(fl=fl, client_parallel="shard_map")
    assert RunConfig(fl=fl).client_axes() is None
    assert "mesh" not in RunConfig(fl=fl).to_json()
    # the fault knobs are ported: accepted, and they switch faults on
    for kw in ({"drop_rate": 0.1}, {"participation_rate": 0.5},
               {"straggler_rate": 0.5, "staleness_max": 2},
               {"staleness_max": 1}):
        run = RunConfig(fl=fl, **kw)
        assert run.has_faults and run.to_json()[next(iter(kw))] == kw[
            next(iter(kw))]
    assert not RunConfig(fl=fl, fault_seed=3).has_faults
    assert RunConfig(fl=fl).replace(drop_rate=0.2).drop_rate == 0.2
    codec = RunConfig(fl=fl, wire="codec", wire_policy="fp16").to_json()
    assert codec["wire"] == "codec" and codec["wire_policy"] == "fp16"
    for kw in ({"client_parallel": "pmap"}, {"wire": "bytes"},
               {"num_micro": 0}, {"straggler_rate": 0.5},
               {"fused_decode": True, "staleness_max": 1},
               # the reference's fault validations
               {"participation_rate": 0.0}, {"participation_rate": 1.5},
               {"drop_rate": 1.0}, {"drop_rate": -0.1},
               {"straggler_rate": 1.5, "staleness_max": 1},
               {"staleness_max": -1}):
        with pytest.raises(ValueError):
            RunConfig(fl=fl, **kw)
        with pytest.raises(ValueError):
            JRunConfig(fl=JFLConfig(), **kw)
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


def _port_round(kind, n, fused=False, **comp_kw):
    comp = CompressorConfig(kind=kind, **comp_kw)
    tmodel = make_mlp(MNIST_SPEC)
    strat = make_strategy(comp, loss_fn=tmodel.syn_loss,
                          syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                          local_lr=LR)
    rf = build_fl_round(tmodel.loss, strat, RunConfig(
        fl=FLConfig(num_clients=n, local_steps=K, local_lr=LR,
                    compressor=comp), fused_decode=fused))
    return rf, strat


@pytest.mark.parametrize("kind", ["identity", "topk", "signsgd", "threesfc"])
def test_rounds_reduce_loss(world, kind):
    """Mirror of tests/test_fl_round.py: 6 rounds on the same batches take
    the mean local loss down."""
    rf, strat = _port_round(kind, N, keep_ratio=0.05, syn_steps=5,
                            error_feedback=kind != "identity")
    state = fl_init(world["tparams"], N, strat)
    losses = []
    for r in range(6):
        state, m = rf(state, world["tbatches"], 3 + r)
        losses.append(float(m.loss))
    assert losses[-1] < losses[0], f"{kind}: loss did not drop: {losses}"


def test_fused_round_trains(world):
    """Mirror of tests/test_fused_decode.py: fused 3SFC (N=3, K=2, B=16, 5
    encoder steps) over 6 rounds of fresh batches takes the loss down, from
    the reference test's params and dataset. (Six noisy rounds are a weak
    signal: on the dataset the port's generator draws, the reference's own
    fused round does not take the loss down either.)"""
    n, k, b = 3, 2, 16
    ds = jdataset(jax.random.PRNGKey(1), 400, (28, 28, 1), 10)
    ds = type(ds)(np.asarray(ds.x), np.asarray(ds.y), ds.num_classes)
    params = world["tparams"]
    comp = CompressorConfig(kind="threesfc", syn_steps=5, syn_lr=0.1)
    tmodel = make_mlp(MNIST_SPEC)
    strat = make_strategy(comp, loss_fn=tmodel.syn_loss,
                          syn_spec=vision_syn_spec(MNIST_SPEC, comp))
    rf = build_fl_round(tmodel.loss, strat, RunConfig(
        fl=FLConfig(num_clients=n, local_steps=k, local_lr=0.05,
                    compressor=comp), fused_decode=True))
    state = fl_init(params, n, strat)
    rng = np.random.default_rng(1)
    losses = []
    for r in range(6):
        bx = np.stack([ds.x[rng.choice(400, (k, b))] for _ in range(n)])
        by = np.stack([ds.y[rng.choice(400, (k, b))] for _ in range(n)])
        state, m = rf(state, {"x": torch.from_numpy(bx),
                              "y": torch.from_numpy(by).long()}, 3 + r)
        losses.append(float(m.loss))
    assert losses[-1] < losses[0], losses


def test_class_image_dataset_learnable_structure():
    """Mirror of tests/test_misc_substrate.py: train and test splits drawn
    from different generators share their class templates, so per-class
    means correlate across them."""
    tr = make_class_image_dataset(torch.Generator().manual_seed(0), 500,
                                  (8, 8, 1), 5)
    te = make_class_image_dataset(torch.Generator().manual_seed(9), 200,
                                  (8, 8, 1), 5)
    for c in range(5):
        m_tr = tr.x[tr.y == c].mean(0).ravel()
        m_te = te.x[te.y == c].mean(0).ravel()
        r = np.corrcoef(m_tr, m_te)[0, 1]
        assert r > 0.8, f"class {c}: templates differ across splits (r={r})"
