"""Port parity for the baseline strategies (``topk``, ``signsgd``, ``stc``),
the budget table and codec-mode rounds, on the CPU.

* ``client_encode`` on the same ``u`` as the reference: top-k index sets
  equal (tied magnitudes may come in another order), reconstructions
  within rtol 1e-6 (signSGD's scale and STC's mu are means summed in
  another order), ``payload_floats`` equal.
* Codec-mode rounds equal float-mode rounds bitwise on the port's own path
  for the lossless codecs (identity, topk, stc without exact-zero kept
  values, threesfc at the fp32 policy), as the reference gates them.
* 3 codec-mode rounds of signSGD and of STC with EF on the paper MLP
  against the reference's codec-mode rounds, from the same params and
  batches: params rtol 1e-4 / atol 1e-6 and EF rtol 1e-4 / atol 1e-5 (the
  bounds tests/test_torch_round.py holds 3SFC to). signSGD sends one bit
  per coordinate, so a coordinate whose |u| sits at rounding level can
  flip (one does at this seed, with |u| < 1e-9). The signSGD
  test therefore runs in lockstep, requires the two sides' signs of u to
  agree wherever |u_ref| > 1e-6·max|u_ref|, leaves the flipped coordinates
  out of that round's comparison and reports how many there were.
* On a tree of ±subnormals, ±0 and normal values, signSGD's and STC's
  reconstructions equal the reference's bitwise: the reference decides
  signs with subnormals flushed to zero, and so does the port
  (``kernels.ftz``).
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.run import RunConfig as JRunConfig
from repro.core.strategy import make_strategy as jmake_strategy
from repro.data.synthetic import make_class_image_dataset as jdataset
from repro.fl.budget import matched_compressors as jmatched
from repro.fl.budget import measured_wire_bytes as jmeasured
from repro.fl.client import local_train as jlocal_train
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models.cnn import MNIST_SPEC as JMNIST
from repro.models.cnn import make_paper_model as jmodel
from repro_torch.comm import make_codec
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.core.strategy import leaf_k, make_strategy, strategy_kinds
from repro_torch.fl.budget import matched_compressors, measured_wire_bytes
from repro_torch.fl.client import local_train
from repro_torch.fl.round import build_fl_round, fl_init
from repro_torch.launch import train
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import MNIST_SPEC, VisionSpec, make_mlp

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, K, BATCH, LR, ROUNDS = 4, 3, 16, 0.05, 3
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)
RECON_RTOL = 1e-6
SIGN_FLOOR = 1e-6          # of max|u_ref|: below it a 1-bit sign may flip


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mlp_d():
    return 784 * 200 + 200 + 200 * 200 + 200 + 200 * 10 + 10


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


def _update(seed):
    """An MLP-shaped update with ~6.5% exact zeros."""
    rng = np.random.default_rng(seed)
    shapes = {"l1": {"w": (784, 200), "b": (200,)},
              "l2": {"w": (200, 200), "b": (200,)},
              "l3": {"w": (200, 10), "b": (10,)}}

    def leaf(shape):
        v = (1e-2 * rng.standard_normal(shape)).astype(np.float32)
        v[rng.random(shape) < 0.065] = 0.0
        return v
    return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _cfgs(kind):
    """(reference, port) configs of ``kind`` from the budget tables."""
    method = {"topk": "dgc"}.get(kind, kind)
    return (jmatched("mlp", JMNIST, _mlp_d())[method],
            matched_compressors("mlp", MNIST_SPEC, _mlp_d())[method])


# ---------------------------------------------------------------------------
# budget table
# ---------------------------------------------------------------------------


def test_budget_table_matches_reference(world):
    want = jmatched("mlp", JMNIST, _mlp_d())
    got = matched_compressors("mlp", MNIST_SPEC, _mlp_d())
    assert sorted(got) == sorted(want)
    for m in want:
        assert vars(got[m]) == vars(want[m]), m
    assert strategy_kinds() == ["fedsynth", "identity", "randk", "signsgd",
                                "stc", "threesfc", "topk"]
    for m, cfg in got.items():
        syn = vision_syn_spec(MNIST_SPEC, cfg) if cfg.kind == "threesfc" \
            else None
        jsyn = None
        if syn is not None:
            from repro.models.build import vision_syn_spec as jsyn_spec
            jsyn = jsyn_spec(JMNIST, want[m])
        assert measured_wire_bytes(cfg, world["tparams"], syn_spec=syn) \
            == jmeasured(want[m], world["params"], syn_spec=jsyn)
    assert measured_wire_bytes(CompressorConfig(kind="randk"),
                               world["tparams"]) is None


def test_leaf_k_matches_reference():
    from repro.core.strategy import leaf_k as jleaf_k
    for n in (1, 7, 200, 156_800):
        for r in (1e-9, 0.0025, 1 / 33, 0.5, 1.0):
            assert leaf_k(n, r) == jleaf_k(n, r)


# ---------------------------------------------------------------------------
# client_encode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["topk", "signsgd", "stc"])
def test_client_encode_matches_reference(world, kind):
    jcfg, cfg = _cfgs(kind)
    u = _update(5)
    jout = jmake_strategy(jcfg).client_encode(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, u), world["params"])
    strat = make_strategy(cfg)
    out = strat.client_encode(None, params_from_numpy(u, CPU),
                              world["tparams"])
    for g, w in zip(jax.tree.leaves(to_numpy(out.recon)),
                    jax.tree.leaves(_np(jout.recon))):
        np.testing.assert_allclose(g, w, rtol=RECON_RTOL, atol=0)
        # zeros at the same places: the kept set is the same
        np.testing.assert_array_equal(g == 0, w == 0)
    assert float(out.floats) == float(jout.floats)
    assert strat.payload_floats(world["tparams"]) == \
        jmake_strategy(jcfg).payload_floats(world["params"])
    if kind == "signsgd":
        np.testing.assert_allclose(out.wire[1].numpy(),
                                   np.asarray(jout.wire[1]), rtol=RECON_RTOL)
        return
    for tw, jw in zip(out.wire, jout.wire):
        # the same kept index set, both in descending order of |u|
        assert set(tw[1].tolist()) == set(np.asarray(jw[1]).tolist())
        np.testing.assert_array_equal(np.sort(tw[1].numpy()),
                                      np.sort(np.asarray(jw[1])))


def subnormal_tree():
    """±subnormals, ±0 and normal values whose means are exact in any
    summation order, with distinct magnitudes among the kept entries (so
    the top-k order is unambiguous): at keep_ratio 1/2 STC keeps 4 of each
    leaf, the three normals and the largest subnormal (-3e-39, +3e-39)."""
    return {"a": np.array([1e-40, -2e-40, -3e-39, 0.5, -0.25, 0.0, -0.0,
                           0.125], np.float32),
            "b": np.array([0.5, -0.25, 0.75, 3e-39, -1e-40, -1e-41, 0.0,
                           -0.0], np.float32)}


SUBNORMAL_KEEP = 0.5


@pytest.mark.parametrize("kind", ["signsgd", "stc"])
def test_subnormal_signs_match_reference_bitwise(kind):
    u = subnormal_tree()
    params = {k: np.zeros_like(v) for k, v in u.items()}
    jout = jmake_strategy(JCompressorConfig(kind=kind,
                                            keep_ratio=SUBNORMAL_KEEP)) \
        .client_encode(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, u),
                       jax.tree.map(jnp.asarray, params))
    out = make_strategy(CompressorConfig(kind=kind,
                                         keep_ratio=SUBNORMAL_KEEP)) \
        .client_encode(None, params_from_numpy(u, CPU),
                       params_from_numpy(params, CPU))
    for g, w in zip(jax.tree.leaves(to_numpy(out.recon)),
                    jax.tree.leaves(_np(jout.recon))):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    if kind == "stc":
        for (tsgn, tidx, tmu), (jsgn, jidx, jmu) in zip(out.wire, jout.wire):
            np.testing.assert_array_equal(tsgn.numpy().view(np.uint32),
                                          np.asarray(jsgn).view(np.uint32))
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            assert float(tmu) == float(jmu)


# ---------------------------------------------------------------------------
# codec-mode round == float-mode round on the port's own path
# ---------------------------------------------------------------------------


TINY = VisionSpec("tiny", (4, 4, 1), 3)


def _tiny_round(kind, wire, fused=False):
    model = make_mlp(TINY)
    params = model.init(torch.Generator().manual_seed(0))
    comp = CompressorConfig(kind=kind, keep_ratio=0.05, syn_steps=2,
                            error_feedback=kind != "identity")
    syn = vision_syn_spec(TINY, comp) if kind == "threesfc" else None
    strat = make_strategy(comp, loss_fn=model.syn_loss, syn_spec=syn,
                          local_lr=0.05)
    run = RunConfig(fl=FLConfig(num_clients=2, local_steps=2, local_lr=0.05,
                                local_batch=4, compressor=comp),
                    wire=wire, fused_decode=fused)
    codec = strat.wire_codec(params) if wire == "codec" else None
    return build_fl_round(model.loss, strat, run, codec=codec), \
        fl_init(params, 2, strat), codec


@pytest.mark.parametrize("kind,fused", [("identity", False), ("topk", False),
                                        ("stc", False), ("threesfc", False),
                                        ("threesfc", True)])
def test_codec_round_equals_float_round(kind, fused):
    g = torch.Generator().manual_seed(1)
    batches = {"x": torch.randn((2, 2, 4, 4, 4, 1), generator=g),
               "y": torch.randint(0, 3, (2, 2, 4), generator=g)}
    f_round, state, _ = _tiny_round(kind, "float", fused)
    c_round, _, codec = _tiny_round(kind, "codec", fused)
    for _ in range(2):                       # EF carries into round 2
        s1, m1 = f_round(state, batches, 3)
        s2, m2 = c_round(state, batches, 3)
        for a, b in zip(jax.tree.leaves(to_numpy(s1)),
                        jax.tree.leaves(to_numpy(s2))):
            np.testing.assert_array_equal(a, b)
        for f in ("loss", "cosine", "payload_floats", "update_norm"):
            np.testing.assert_array_equal(getattr(m1, f).numpy(),
                                          getattr(m2, f).numpy())
        assert m1.wire_bytes_up == 0.0
        assert m2.wire_bytes_up == codec.nbytes
        state = s2


def test_signsgd_codec_round_keeps_the_one_bit_convention():
    """signSGD's codec round differs from its float round only through the
    1-bit convention: exact zeros of u decode to +scale (the reference
    behaves the same; BENCH_wire.json). The server's decode equals the
    client's view, so client EF and server stay consistent."""
    model = make_mlp(TINY)
    params = model.init(torch.Generator().manual_seed(0))
    comp = CompressorConfig(kind="signsgd")
    strat = make_strategy(comp)
    codec = strat.wire_codec(params)
    u = flat.tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator()
                                            .manual_seed(p.numel())), params)
    u["l1"]["w"][0, :5] = 0.0
    out = strat.client_encode(None, u, params)
    view, _, _ = codec.client_view(out)
    recon = codec.recon_tree(codec.decode(codec.encode(out.wire)), params)
    for lu, lr, lv, lf in zip(*[flat.tree_leaves(t)
                                for t in (u, recon, view, out.recon)]):
        np.testing.assert_array_equal(lr.numpy(), lv.numpy())
        nz = lu != 0
        np.testing.assert_array_equal(lr[nz].numpy(), lf[nz].numpy())
        assert bool((lr[~nz] > 0).all())


def test_codec_mode_rejects_bad_pairs():
    model = make_mlp(TINY)
    params = model.init(torch.Generator().manual_seed(0))
    comp = CompressorConfig(kind="topk", keep_ratio=0.05)
    strat = make_strategy(comp)
    run = RunConfig(fl=FLConfig(num_clients=2, compressor=comp), wire="codec")
    with pytest.raises(ValueError, match="requires a codec"):
        build_fl_round(model.loss, strat, run)
    with pytest.raises(ValueError, match="does not match"):
        build_fl_round(model.loss, strat, run, codec=make_codec(
            CompressorConfig(kind="signsgd"), params))
    with pytest.raises(ValueError, match="'float' or 'codec'"):
        RunConfig(fl=FLConfig(num_clients=2, compressor=comp), wire="bytes")
    tcomp = CompressorConfig(kind="threesfc")
    syn = vision_syn_spec(TINY, tcomp)
    tstrat = make_strategy(tcomp, loss_fn=model.syn_loss, syn_spec=syn)
    with pytest.raises(ValueError, match="fp32"):
        build_fl_round(model.loss, tstrat, RunConfig(
            fl=FLConfig(num_clients=2, compressor=tcomp), wire="codec"),
            codec=make_codec(tcomp, params, syn_spec=syn, policy="bf16"))


# ---------------------------------------------------------------------------
# 3 codec-mode rounds against the reference's, on the MLP
# ---------------------------------------------------------------------------


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


def _clients_u(world, jstate, tmodel):
    """Each client's u = g + e, flat, on both sides from the reference's
    state (the port's round starts from the same numbers)."""
    out = []
    for i in range(N):
        jb = jax.tree.map(lambda x: x[i], world["batches"])
        g, _ = jlocal_train(world["model"].loss, jstate.params, jb, LR)
        ju = jax.tree.map(lambda a, e: a + e[i], g, jstate.ef)
        tb = flat.tree_map(lambda x: x[i], world["tbatches"])
        tg, _ = local_train(tmodel.loss, params_from_numpy(
            _np(jstate.params), CPU), tb, LR)
        tu = flat.tree_map(lambda a, e: a + e[i], tg,
                           params_from_numpy(_np(jstate.ef), CPU))
        out.append((_flat(_np(ju)), _flat(to_numpy(tu))))
    return out


def _assert_close_outside(got, want, skip, **tol):
    """``got`` ≈ ``want`` (flat) except at the indices in ``skip``."""
    keep = np.ones(want.shape, bool)
    keep[list(skip)] = False
    np.testing.assert_allclose(got[keep], want[keep], **tol)


@pytest.mark.parametrize("kind", ["signsgd", "stc"])
def test_codec_rounds_match_reference(world, kind, record_property):
    """STC runs 3 rounds free on both sides. signSGD runs in lockstep —
    each port round starts from the reference's state — because a 1-bit
    sign that flips at rounding level moves that coordinate by 2·scale and
    the difference would carry into every later round; the flipped
    coordinates (all below the floor, counted) are left out of that
    round's comparison, everything else is held to the tolerance."""
    jcfg, cfg = _cfgs(kind)
    jstrat = jmake_strategy(jcfg, local_lr=LR)
    jround = jax.jit(jbuild_round(world["model"].loss, jstrat, JRunConfig(
        fl=JFLConfig(num_clients=N, local_steps=K, local_lr=LR,
                     compressor=jcfg), wire="codec"),
        codec=jstrat.wire_codec(world["params"])))
    tmodel = make_mlp(MNIST_SPEC)
    tstrat = make_strategy(cfg, local_lr=LR)
    codec = tstrat.wire_codec(world["tparams"])
    tround = build_fl_round(tmodel.loss, tstrat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=cfg), wire="codec"), codec=codec)
    js = jfl_init(world["params"], N)
    ts = fl_init(world["tparams"], N, tstrat)
    lockstep = kind == "signsgd"
    key = jax.random.PRNGKey(3)
    flips = 0
    for _ in range(ROUNDS):
        skip_ef = [set() for _ in range(N)]
        if lockstep:
            ts = ts._replace(params=params_from_numpy(_np(js.params), CPU),
                             ef=params_from_numpy(_np(js.ef), CPU))
            for i, (ju, tu) in enumerate(_clients_u(world, js, tmodel)):
                flip = np.nonzero((ju >= 0) != (tu >= 0))[0]
                assert (np.abs(ju[flip]) <= SIGN_FLOOR * np.abs(ju).max()) \
                    .all(), (ju[flip], tu[flip])
                skip_ef[i].update(flip.tolist())
                flips += len(flip)
        key, kr = jax.random.split(key)
        js, jm = jround(js, world["batches"], kr)
        ts, tm = tround(ts, world["tbatches"], 0)
        assert tm.wire_bytes_up == float(jm.wire_bytes_up) == codec.nbytes
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(tm.cosine.numpy(), np.asarray(jm.cosine),
                                   rtol=1e-4, atol=1e-6)
        skip_p = set().union(*skip_ef)
        _assert_close_outside(_flat(to_numpy(ts.params)), _flat(_np(js.params)),
                              skip_p, **PARAM_TOL)
        for i in range(N):
            _assert_close_outside(
                _flat(to_numpy(flat.tree_map(lambda e: e[i], ts.ef))),
                _flat(_np(jax.tree.map(lambda e: e[i], js.ef))),
                skip_ef[i], **EF_TOL)
    if lockstep:
        # a flip needs |u| at rounding level: a handful among N·d coordinates
        assert flips <= 1e-5 * ROUNDS * N * _mlp_d()
        record_property("sign_flips_below_floor", flips)
        print(f"{kind}: {flips} sign flips of u, all below "
              f"{SIGN_FLOOR}·max|u_ref|, in {ROUNDS} rounds of {N} clients")


# ---------------------------------------------------------------------------
# the trainer in codec mode
# ---------------------------------------------------------------------------


def test_trainer_codec_mode_writes_reference_metric_keys(tmp_path):
    out = tmp_path / "run"
    train.main(["--model", "mlp", "--dataset", "mnist", "--compressor",
                "signsgd", "--wire", "codec", "--rounds", "2", "--clients",
                "3", "--local-steps", "2", "--batch", "8", "--train-size",
                "200", "--eval-every", "1", "--device", "cpu", "--out",
                str(out)])
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["round"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"round", "loss", "acc", "cos", "payload_floats",
                          "elapsed_s"}
        assert np.isfinite(r["loss"]) and np.isfinite(r["cos"])
        assert r["payload_floats"] == _mlp_d() / 32.0 + 6
    cfg = json.load(open(os.path.join(out, "run_config.json")))
    assert cfg["wire"] == "codec" and cfg["wire_policy"] == "fp32"
    assert cfg["fl"]["compressor"]["kind"] == "signsgd"


def test_runconfig_from_flags_carries_the_wire():
    args = types.SimpleNamespace(clients=3, local_steps=2, lr=0.1, batch=8,
                                 rounds=4, alpha=0.3, seed=5, wire="codec",
                                 wire_policy="bf16")
    run = RunConfig.from_flags(args, compressor=CompressorConfig(kind="stc"))
    assert run.wire == "codec" and run.wire_policy == "bf16"
    assert run.fl.num_clients == 3 and run.fl.seed == 5
    assert run.to_json()["wire_policy"] == "bf16"
    plain = RunConfig.from_flags(types.SimpleNamespace(
        clients=3, local_steps=2, lr=0.1, batch=8, rounds=4, seed=0),
        compressor=CompressorConfig())
    assert plain.wire == "float" and plain.wire_policy == "fp32"
