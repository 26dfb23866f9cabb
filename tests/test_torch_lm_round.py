"""Port parity for federated LM training on the CPU: the FL round on the
mamba2 smoke LM (3SFC+EF in float and fused decode, signSGD in codec
mode), the LM trainer (``repro_torch.launch.train --arch --smoke``),
``fl.engine.token_batcher``, ``data.synthetic.make_token_dataset`` and
``repro_torch.optim``.

The reference draws the params; batches and every client's ``syn0`` are
drawn on its side and handed across as numpy, so both rounds start every
client from the same numbers. Params are held to rtol 1e-4 / atol 1e-6 and
EF to rtol 1e-4 / atol 1e-5, the bounds of tests/test_torch_round.py (the
reference's fused-vs-float bounds, tests/test_fused_decode.py): the two
sides differ only in summation order.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import make_codec as jmake_codec
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.configs.run import RunConfig as JRunConfig
from repro.core import flat as jflat
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.data.synthetic import make_token_dataset as jmake_token_dataset
from repro.fl.client import local_train as jlocal_train
from repro.fl.engine import token_batcher as jtoken_batcher
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models.build import build_model as jbuild_model
from repro.models.build import syn_loss_fn as jsyn_loss_fn
from repro.models.build import syn_spec_for as jsyn_spec_for
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.configs.base import (CompressorConfig, FLConfig,
                                     get_smoke_config)
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.core.threesfc import SynData
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.fl.engine import token_batcher
from repro_torch.fl.round import build_fl_round, fl_init, fold_in
from repro_torch.launch import train
from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for
from repro_torch.optim import OptState, make_optimizer

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, K, BATCH, SEQ, LR = 3, 2, 2, 16, 0.05
ROUNDS, SYN_STEPS = 3, 3
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)
SIGN_FLOOR = 1e-6          # of max|u_ref|: below it a 1-bit sign may flip


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(got, want, **tol):
    g, w = jax.tree.leaves(to_numpy(got)), jax.tree.leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **tol)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


@pytest.fixture(scope="module")
def world():
    jcfg = jget_smoke_config("mamba2-370m")
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (N, K, BATCH, SEQ)).astype(
        np.int32)
    return {"jcfg": jcfg, "model": jmodel, "params": params,
            "batches": {"tokens": jnp.asarray(tokens)},
            "tparams": params_from_numpy(_np(params), CPU),
            "tbatches": {"tokens": torch.from_numpy(tokens.copy())}}


def _threesfc_cfgs():
    kw = dict(kind="threesfc", syn_steps=SYN_STEPS, syn_lr=0.1, syn_seq=4,
              soft_label_rank=8)
    return JCompressorConfig(**kw), CompressorConfig(**kw)


def _rounds(world, fused):
    """ROUNDS 3SFC+EF rounds on both sides; each reference round key feeds
    its clients' syn0 to the port."""
    jcomp, comp = _threesfc_cfgs()
    jspec = jsyn_spec_for(world["jcfg"], jcomp)
    jstrat = jmake_strategy(jcomp, loss_fn=jsyn_loss_fn(world["model"]),
                            syn_spec=jspec, local_lr=LR)
    jround = jax.jit(jbuild_round(world["model"].loss, jstrat, JRunConfig(
        fl=JFLConfig(num_clients=N, local_steps=K, local_lr=LR,
                     compressor=jcomp), fused_decode=fused)))
    cfg = get_smoke_config("mamba2-370m")
    model = build_model(cfg)
    tstrat = make_strategy(comp, loss_fn=syn_loss_fn(model),
                           syn_spec=syn_spec_for(cfg, comp), local_lr=LR)
    tround = build_fl_round(model.loss, tstrat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=comp), fused_decode=fused))
    js = jfl_init(world["params"], N)
    ts = fl_init(world["tparams"], N, tstrat)
    key = jax.random.PRNGKey(3)
    out = []
    for _ in range(ROUNDS):
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
    return _rounds(world, False)


@pytest.fixture(scope="module")
def threesfc_fused(world):
    return _rounds(world, True)


@pytest.mark.parametrize("mode", ["float", "fused"])
def test_threesfc_ef_lm_rounds_match_reference(request, mode):
    metrics, js, ts = request.getfixturevalue(f"threesfc_{mode}")
    assert ts.round == int(js.round) == ROUNDS
    _assert_close(ts.params, js.params, **PARAM_TOL)
    _assert_close(ts.ef, js.ef, **EF_TOL)
    for jm, tm in metrics:
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(tm.cosine.numpy(), np.asarray(jm.cosine),
                                   rtol=1e-4, atol=1e-6)
        assert float(tm.payload_floats) == float(jm.payload_floats)


def test_lm_payload_is_the_reference_budget(threesfc_float, world):
    """x (1, 4, d_model) + low-rank labels (1, 4, 8) and (8, V) + s."""
    metrics, _, _ = threesfc_float
    cfg = world["jcfg"]
    want = 4 * cfg.d_model + 4 * 8 + 8 * cfg.vocab_size + 1
    for _, tm in metrics:
        assert float(tm.payload_floats) == want


def test_fused_lm_decode_matches_float_decode(threesfc_float, threesfc_fused):
    _, _, ts_float = threesfc_float
    _, _, ts_fused = threesfc_fused
    for a, b in zip(tree_leaves(ts_fused.params),
                    tree_leaves(ts_float.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)


def test_signsgd_codec_lm_round_matches_reference(world):
    """One signSGD codec round (EF on) from the same state on both sides.
    Every client's frame of the reference's payload is byte for byte the
    reference's; the port's own frame (from its own u) has the reference's
    header and sign bits wherever |u_ref| is above SIGN_FLOOR·max|u_ref|
    (below it a 1-bit sign may flip at rounding level), and its per-leaf
    scales within rtol 1e-5; params and EF are held to the tolerances away
    from those flips."""
    jcomp, comp = JCompressorConfig(kind="signsgd"), \
        CompressorConfig(kind="signsgd")
    jstrat = jmake_strategy(jcomp, local_lr=LR)
    jcodec = jmake_codec(jcomp, world["params"])
    jround = jax.jit(jbuild_round(world["model"].loss, jstrat, JRunConfig(
        fl=JFLConfig(num_clients=N, local_steps=K, local_lr=LR,
                     compressor=jcomp), wire="codec"), codec=jcodec))
    model = build_model(get_smoke_config("mamba2-370m"))
    tstrat = make_strategy(comp, local_lr=LR)
    codec = tstrat.wire_codec(world["tparams"])
    frames = []
    encode = codec.encode
    codec.encode = lambda wire, **kw: frames.append(encode(wire, **kw)) \
        or frames[-1]
    tround = build_fl_round(model.loss, tstrat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=comp), wire="codec"), codec=codec)
    signs_at, scales_at = codec.spec.section_offsets
    d = codec.d
    wants, skip = [], set()
    for i in range(N):
        # EF starts at zero, so u = g
        jb = jax.tree.map(lambda x: x[i], world["batches"])
        g, _ = jlocal_train(world["model"].loss, world["params"], jb, LR)
        jwire = jstrat.client_encode(jax.random.PRNGKey(0), g,
                                     world["params"]).wire
        want = np.asarray(jcodec.encode(jwire, round_idx=0, client_idx=i))
        got = encode((params_from_numpy(_np(jwire[0]), CPU),
                      torch.from_numpy(np.array(jwire[1]))),
                     round_idx=0, client_idx=i)
        np.testing.assert_array_equal(got.numpy(), want)
        u = _flat(_np(g))
        wants.append((want, u))
        skip.update(np.nonzero(np.abs(u) <= SIGN_FLOOR * np.abs(u).max())[0]
                    .tolist())
    js, jm = jround(jfl_init(world["params"], N), world["batches"],
                    jax.random.PRNGKey(0))
    ts, tm = tround(fl_init(world["tparams"], N, tstrat),
                    world["tbatches"], 0)
    assert len(frames) == N
    assert tm.wire_bytes_up == float(jm.wire_bytes_up) == codec.nbytes
    for frame, (want, u) in zip(frames, wants):
        got = frame.numpy()
        np.testing.assert_array_equal(got[:signs_at], want[:signs_at])
        bits = np.unpackbits(got[signs_at:scales_at], bitorder="little")[:d]
        wbits = np.unpackbits(want[signs_at:scales_at],
                              bitorder="little")[:d]
        flips = np.nonzero(bits != wbits)[0]
        assert (np.abs(u[flips]) <= SIGN_FLOOR * np.abs(u).max()).all()
        np.testing.assert_allclose(got[scales_at:].view(np.float32),
                                   want[scales_at:].view(np.float32),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
    keep = np.ones(d, bool)
    keep[sorted(skip)] = False
    np.testing.assert_allclose(_flat(to_numpy(ts.params))[keep],
                               _flat(_np(js.params))[keep], **PARAM_TOL)
    for i in range(N):
        np.testing.assert_allclose(
            _flat(to_numpy(flat.tree_map(lambda e: e[i], ts.ef)))[keep],
            _flat(_np(jax.tree.map(lambda e: e[i], js.ef)))[keep], **EF_TOL)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compressor,extra", [
    ("threesfc", []), ("fedavg", []), ("signsgd", ["--wire", "codec"]),
    ("threesfc", ["--drop-rate", "0.5", "--participation-rate", "0.5"])])
def test_lm_smoke_trainer_writes_reference_rows(tmp_path, compressor, extra,
                                                capsys):
    """``--arch mamba2-370m --smoke --device cpu`` prints and writes one row
    per eval with the reference's keys; ``params`` is the smoke LM's size.
    The wire and fault flags apply as in the vision runs."""
    out = tmp_path / "run"
    state = train.main(["--arch", "mamba2-370m", "--smoke", "--compressor",
                        compressor, "--rounds", "2", "--clients", "2",
                        "--local-steps", "1", "--batch", "2",
                        "--eval-every", "1", "--device", "cpu", "--out",
                        str(out), *extra])
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert rows == printed
    d = jflat.tree_size(jbuild_model(jget_smoke_config(
        "mamba2-370m")).init(jax.random.PRNGKey(0)))
    assert [r["round"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"round", "loss", "cos", "params"}
        assert np.isfinite(r["loss"]) and np.isfinite(r["cos"])
        assert r["params"] == d == flat.tree_size(state.params)
    cfg = json.load(open(os.path.join(out, "run_config.json")))
    assert cfg["arch"] == "mamba2-370m" and cfg["seq_len"] == 64
    assert cfg["num_micro"] == 1
    assert cfg["fl"]["compressor"]["kind"] == (
        "identity" if compressor == "fedavg" else compressor)
    assert cfg["wire"] == ("codec" if "--wire" in extra else "float")
    assert cfg["drop_rate"] == (0.5 if "--drop-rate" in extra else 0.0)


@pytest.mark.parametrize("per_client,seq,want", [
    (2, 4096, 2), (16, 4096, 8), (6, 8192, 6), (12, 4096, 6), (4, 64, 1),
    (32, 2048, 1)])
def test_num_micro_follows_the_reference_rule(per_client, seq, want):
    """launch/specs.py make_train_entry: from 4,096 tokens, min(B, 8)
    lowered to a divisor of B."""
    assert train.num_micro_for(per_client, seq) == want


# ---------------------------------------------------------------------------
# token batcher and token dataset
# ---------------------------------------------------------------------------


def test_token_batcher_shapes_and_determinism():
    """tests/test_engine.py::test_token_batcher_shapes_and_determinism."""
    toks = np.arange(50 * 7, dtype=np.int32).reshape(50, 7) % 13
    bf = token_batcher(toks, num_clients=3, local_steps=2, local_batch=4,
                       extras={"frames": (5, 8)})
    b1, b2, b3 = bf(0, 4), bf(0, 4), bf(0, 5)
    assert tuple(b1["tokens"].shape) == (3, 2, 4, 7)
    assert tuple(b1["frames"].shape) == (3, 2, 4, 5, 8)
    assert b1["frames"].dtype == torch.float32 and not b1["frames"].any()
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    # the reference's shapes and dtypes for the same arguments
    jb = jtoken_batcher(toks, num_clients=3, local_steps=2, local_batch=4,
                        extras={"frames": (5, 8)})(jax.random.PRNGKey(0),
                                                   jnp.int32(4))
    for k in jb:
        assert tuple(b1[k].shape) == jb[k].shape
    assert b1["tokens"].dtype == torch.int32


def test_token_batcher_rows_are_a_function_of_seed_round_client():
    """Client i of round r draws its rows from fold_in(data_seed, r, i):
    every sampled row is a row of the set, and one client's rows do not
    depend on the client count."""
    toks = np.arange(40 * 5, dtype=np.int32).reshape(40, 5)
    b3 = token_batcher(toks, 3, 2, 4)(7, 2)["tokens"]
    b2 = token_batcher(toks, 2, 2, 4)(7, 2)["tokens"]
    assert torch.equal(b3[:2], b2)
    gen = torch.Generator().manual_seed(fold_in(7, 2, 1))
    rows = torch.randint(0, 40, (2, 4), generator=gen)
    assert torch.equal(b3[1], torch.from_numpy(toks)[rows])


def test_token_dataset_bigram_structure():
    """tests/test_misc_substrate.py::test_token_dataset_bigram_structure."""
    seqs = make_token_dataset(torch.Generator().manual_seed(0), 64, 32, 50,
                              noise=0.0)
    assert seqs.shape == (64, 32) and seqs.dtype == np.int32
    nxt = {}
    for s in seqs:
        for a, b in zip(s[:-1], s[1:]):
            assert nxt.setdefault(int(a), int(b)) == int(b)
    # the reference's shapes, dtype and range for the same arguments
    ref = jmake_token_dataset(jax.random.PRNGKey(0), 64, 32, 50, noise=0.0)
    assert ref.shape == seqs.shape and ref.dtype == seqs.dtype
    assert seqs.min() >= 0 and seqs.max() < 50


def test_token_dataset_noise_rate():
    """With noise, a step leaves the bigram map with probability about
    noise·(1 - 1/V): the map recovered from the noiseless run explains the
    rest."""
    vocab, noise = 50, 0.3
    clean = make_token_dataset(torch.Generator().manual_seed(1), 8, 16,
                               vocab, noise=0.0)
    seqs = make_token_dataset(torch.Generator().manual_seed(1), 400, 64,
                              vocab, noise=noise)
    nxt = {}
    for s in clean:
        for a, b in zip(s[:-1], s[1:]):
            nxt[int(a)] = int(b)
    pairs = [(int(a), int(b)) for s in seqs for a, b in zip(s[:-1], s[1:])
             if int(a) in nxt]
    off = np.mean([nxt[a] != b for a, b in pairs])
    assert abs(off - noise * (1 - 1 / vocab)) < 0.02


# ---------------------------------------------------------------------------
# optimizers (tests/test_misc_substrate.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_minimize_quadratic(name):
    init, update = make_optimizer(name, lr=0.1)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = init(params)
    for _ in range(200):
        g = {"x": 2.0 * params["x"]}
        params, state = update(params, g, state)
    assert float(torch.sum(params["x"] ** 2)) < 1e-3
    assert int(state.step) == 200 and state.step.dtype == torch.int32


def test_optimizer_preserves_dtype():
    init, update = make_optimizer("adam", lr=0.01)
    params = {"x": torch.ones((4,), dtype=torch.bfloat16)}
    state = init(params)
    g = {"x": torch.ones((4,), dtype=torch.bfloat16)}
    params, state = update(params, g, state)
    assert params["x"].dtype == torch.bfloat16
    assert state.mu["x"].dtype == state.nu["x"].dtype == torch.float32


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {"beta": 0.8}),
                                     ("adam", {}), ("adam", {"b1": 0.8,
                                                             "eps": 1e-6})])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_steps_match_reference(name, kw, dtype):
    """Five steps on the same gradients: params and moments match the
    reference's, bitwise in bf16 params' dtype to within one bf16 ulp and
    within rtol 1e-6 in f32."""
    rng = np.random.default_rng(2)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jinit, jupdate = jmake_optimizer(name, 0.05, **kw)
    init, update = make_optimizer(name, 0.05, **kw)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    js, ts = jinit(jp), init(tp)
    for g in grads:
        jp, js = jupdate(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                        ts)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=0)
    for k in p0:
        assert tp[k].dtype == tdt
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32), **tol)
    assert isinstance(ts, OptState) and int(ts.step) == int(js.step) == 5
    for tm, jm in ((ts.mu, js.mu), (ts.nu, js.nu)):
        assert len(jax.tree.leaves(jm)) == len(tree_leaves(tm))
        for a, b in zip(tree_leaves(tm), jax.tree.leaves(jm)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
