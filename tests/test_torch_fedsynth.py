"""Port parity for FedSynth (``repro_torch.core.fedsynth`` and the
``fedsynth`` strategy) and the rounds of the two accounted-only strategies,
on the CPU, on a narrow MLP (6x6x1 inputs, 4 classes, hidden 16).

The reference draws the params, the target and ``syn0``; the port starts
from the same numbers, carried across as numpy.

Tolerance: the 3SFC encoder's (tests/test_torch_threesfc.py) — scalars
rtol 1e-5, trees rtol 1e-4 with an absolute floor of 1e-5 of the tree's
largest element. The two sides differ only in summation order, and the
gradient through the K-step unroll carries that through every simulated
step. At syn_lr 10 (D_syn moves, the syn-grad norm falls by 3x over the 10
steps) the port stays within 3e-7 relative of the reference's D_syn and
within 2e-8 absolute of its recon, the same order as the reference's own
spread when its target moves by one ulp; the bounds hold with margin.
Rounds are held to tests/test_torch_round.py's bounds: params rtol 1e-4 /
atol 1e-6, EF rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.run import RunConfig as JRunConfig
from repro.core import fedsynth as jfedsynth
from repro.core import flat as jflat
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models.build import vision_syn_spec as jsyn_spec
from repro.models.cnn import VisionSpec as JVisionSpec
from repro.models.cnn import make_mlp as jmake_mlp
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import fedsynth, flat
from repro_torch.core.strategy import leaf_k, make_strategy
from repro_torch.core.threesfc import SynData
from repro_torch.fl.client import local_train
from repro_torch.fl.round import build_fl_round, fl_init
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import VisionSpec, make_mlp

torch.set_num_threads(2)

CPU = torch.device("cpu")
SHAPE, CLASSES, HIDDEN = (6, 6, 1), 4, 16
N, K, BATCH, LR, ROUNDS = 4, 3, 8, 0.05, 3
UNROLL, OPT_STEPS, SYN_LR = 5, 10, 10.0
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
TREE_RTOL, TREE_ATOL_OF_MAX = 1e-4, 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    tree = tuple(tree) if isinstance(tree, SynData) else tree
    return jax.tree.leaves(to_numpy(tree))


def _close_trees(got, want):
    g_leaves, w_leaves = _leaves(got), jax.tree.leaves(_np(want))
    assert len(g_leaves) == len(w_leaves)
    top = max(float(np.abs(w).max()) for w in w_leaves if w.size)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, w, rtol=TREE_RTOL,
                                   atol=TREE_ATOL_OF_MAX * top)


def _syn_to_torch(syn):
    return SynData(*[torch.from_numpy(np.array(t)) for t in syn])


@pytest.fixture(scope="module")
def world():
    jspec = JVisionSpec("narrow", SHAPE, CLASSES)
    model = jmake_mlp(jspec, hidden=HIDDEN)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    bx = rng.random((N, K, BATCH, *SHAPE)).astype(np.float32)
    by = rng.integers(0, CLASSES, (N, K, BATCH)).astype(np.int32)
    # a target update: K real SGD steps of client 0
    p = params
    for k in range(K):
        g = jax.grad(model.loss)(p, {"x": jnp.asarray(bx[0, k]),
                                     "y": jnp.asarray(by[0, k])})
        p = jax.tree.map(lambda a, b: a - LR * b, p, g)
    comp = JCompressorConfig(kind="fedsynth")
    tspec = VisionSpec("narrow", SHAPE, CLASSES)
    return {"jmodel": model, "params": params,
            "target": jflat.tree_sub(params, p),
            "batches": {"x": jnp.asarray(bx), "y": jnp.asarray(by)},
            "jsyn_spec": jsyn_spec(jspec, comp),
            "tmodel": make_mlp(tspec, hidden=HIDDEN),
            "tsyn_spec": vision_syn_spec(tspec, CompressorConfig(
                kind="fedsynth")),
            "tparams": params_from_numpy(_np(params), CPU),
            "tbatches": params_from_numpy({"x": bx, "y": by}, CPU)}


@pytest.fixture(scope="module")
def encoded(world):
    syn0 = jthreesfc.init_syn(jax.random.PRNGKey(2), world["jsyn_spec"])
    kw = dict(unroll_steps=UNROLL, opt_steps=OPT_STEPS, lr=LR,
              syn_lr=SYN_LR)
    ref = jfedsynth.encode(world["jmodel"].syn_loss, world["params"],
                           world["target"], syn0, **kw)
    got = fedsynth.encode(world["tmodel"].syn_loss, world["tparams"],
                          params_from_numpy(_np(world["target"]), CPU),
                          _syn_to_torch(syn0), **kw)
    return ref, got, syn0


# ---------------------------------------------------------------------------
# the encoder against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["l2", "syn_grad_norm"])
def test_encode_scalars_match_reference(encoded, field):
    ref, got, _ = encoded
    np.testing.assert_allclose(float(getattr(got, field)),
                               float(getattr(ref, field)), **SCALAR_TOL)


@pytest.mark.parametrize("field", ["recon", "syn"])
def test_encode_trees_match_reference(encoded, field):
    ref, got, _ = encoded
    _close_trees(getattr(got, field), getattr(ref, field))


def test_encode_moves_the_synthetic_data(encoded):
    """The comparison is not vacuous: D_syn moved away from syn0."""
    _, got, syn0 = encoded
    moved = max(float(np.abs(g - np.asarray(s)).max())
                for g, s in zip(_leaves(got.syn), syn0) if g.size)
    assert moved > 1e-3


def test_decode_reproduces_the_encoder_recon(world, encoded):
    ref, got, _ = encoded
    back = fedsynth.decode(world["tmodel"].syn_loss, world["tparams"],
                           got.syn, UNROLL, LR)
    for a, b in zip(_leaves(back), _leaves(got.recon)):
        np.testing.assert_array_equal(a, b)
    jback = jfedsynth.decode(world["jmodel"].syn_loss, world["params"],
                             ref.syn, UNROLL, LR)
    _close_trees(fedsynth.decode(world["tmodel"].syn_loss, world["tparams"],
                                 _syn_to_torch(ref.syn), UNROLL, LR), jback)


def test_encode_needs_an_optimization_step(world, encoded):
    _, got, _ = encoded
    with pytest.raises(ValueError, match="opt_steps"):
        fedsynth.encode(world["tmodel"].syn_loss, world["tparams"],
                        got.recon, got.syn, opt_steps=0)


def test_strategy_encode_matches_reference(world):
    """The strategy's settings: opt_steps = max(syn_steps, 10), lr =
    local_lr, its syn_lr; a SynData key is the initial D_syn."""
    jcfg = JCompressorConfig(kind="fedsynth", syn_steps=3, syn_lr=SYN_LR,
                             unroll_steps=3)
    key = jax.random.PRNGKey(7)
    jout = jmake_strategy(jcfg, loss_fn=world["jmodel"].syn_loss,
                          syn_spec=world["jsyn_spec"], local_lr=LR) \
        .client_encode(key, world["target"], world["params"])
    syn0 = jthreesfc.init_syn(key, world["jsyn_spec"])
    strat = make_strategy(CompressorConfig(kind="fedsynth", syn_steps=3,
                                           syn_lr=SYN_LR, unroll_steps=3),
                          loss_fn=world["tmodel"].syn_loss,
                          syn_spec=world["tsyn_spec"], local_lr=LR)
    out = strat.client_encode(_syn_to_torch(syn0),
                              params_from_numpy(_np(world["target"]), CPU),
                              world["tparams"])
    _close_trees(out.recon, jout.recon)
    np.testing.assert_allclose(float(out.aux), float(jout.aux), **SCALAR_TOL)
    assert float(out.floats) == float(jout.floats) == \
        strat.syn_spec.floats + 1.0
    assert out.wire is None and out.cosine is None and out.direction is None
    # from a generator: finite, and the draw decides the result
    a = strat.client_encode(torch.Generator().manual_seed(1),
                            params_from_numpy(_np(world["target"]), CPU),
                            world["tparams"])
    assert all(np.isfinite(l).all() for l in _leaves(a.recon))


# ---------------------------------------------------------------------------
# float-mode rounds
# ---------------------------------------------------------------------------


def _close(got, want, **tol):
    for g, w in zip(jax.tree.leaves(to_numpy(got)), jax.tree.leaves(_np(want))):
        np.testing.assert_allclose(g, w, **tol)


def test_fedsynth_rounds_match_reference(world):
    """3 rounds with EF on, each reference round key's clients' syn0 fed to
    the port (the ``syn0`` seam)."""
    ccfg = dict(kind="fedsynth", syn_lr=SYN_LR, unroll_steps=UNROLL)
    jcomp = JCompressorConfig(**ccfg)
    jstrat = jmake_strategy(jcomp, loss_fn=world["jmodel"].syn_loss,
                            syn_spec=world["jsyn_spec"], local_lr=LR)
    jround = jax.jit(jbuild_round(world["jmodel"].loss, jstrat, JRunConfig(
        fl=JFLConfig(num_clients=N, local_steps=K, local_lr=LR,
                     compressor=jcomp))))
    comp = CompressorConfig(**ccfg)
    tstrat = make_strategy(comp, loss_fn=world["tmodel"].syn_loss,
                           syn_spec=world["tsyn_spec"], local_lr=LR)
    tround = build_fl_round(world["tmodel"].loss, tstrat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=comp)))
    js = jfl_init(world["params"], N)
    ts = fl_init(world["tparams"], N, tstrat)
    key = jax.random.PRNGKey(3)
    for _ in range(ROUNDS):
        key, kr = jax.random.split(key)
        syns = jax.vmap(lambda k: jthreesfc.init_syn(k, world["jsyn_spec"]))(
            jax.random.split(kr, N))
        js, jm = jround(js, world["batches"], kr)
        ts, tm = tround(ts, world["tbatches"], 0, syn0=_syn_to_torch(syns))
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(tm.cosine.numpy(), np.asarray(jm.cosine),
                                   rtol=1e-4, atol=1e-6)
        assert float(tm.payload_floats) == float(jm.payload_floats)
        _close(ts.params, js.params, **PARAM_TOL)
        _close(ts.ef, js.ef, **EF_TOL)
    assert float(flat.tree_norm(ts.ef)) > 0


def test_randk_rounds_keep_the_support_and_telescope(world):
    """3 randk rounds with EF on. Client i's draws come from its round
    generator, leaf after leaf: replaying them gives leaf_k distinct
    indices per leaf, and the round's new residual is exactly u − recon
    with recon = u on those indices and 0 elsewhere. Over the rounds no
    update mass is lost (Eq. 6 at the round level):
    params_0 − params_T + mean_i e_i,T = mean_i Σ_t g_i,t."""
    from repro_torch.core import baselines
    from repro_torch.fl.round import client_generator
    ratio = 0.05
    comp = CompressorConfig(kind="randk", keep_ratio=ratio)
    strat = make_strategy(comp, local_lr=LR)
    model = world["tmodel"]
    fl_round = build_fl_round(model.loss, strat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=comp)))
    state = fl_init(world["tparams"], N, strat)
    total_g = flat.tree_zeros_like(world["tparams"])
    for r in range(ROUNDS):
        new, m = fl_round(state, world["tbatches"], r)
        assert float(m.payload_floats) == strat.payload_floats(
            world["tparams"])
        assert bool(torch.isfinite(m.cosine).all())
        for i in range(N):
            g, _ = local_train(model.loss, state.params,
                               flat.tree_map(lambda x: x[i],
                                             world["tbatches"]), LR)
            total_g = flat.tree_add(total_g, flat.tree_scale(g, 1.0 / N))
            gen = client_generator(r, i, CPU)
            for l_g, l_e, l_new in zip(
                    *[flat.tree_leaves(t) for t in
                      (g, flat.tree_map(lambda e: e[i], state.ef),
                       flat.tree_map(lambda e: e[i], new.ef))]):
                u = (l_g + l_e).reshape(-1)
                k = leaf_k(u.numel(), ratio)
                payload, recon = baselines.randk_compress(gen, u, k)
                idx = payload.data[1]
                assert torch.unique(idx).numel() == k
                assert torch.equal(recon[idx], u[idx])
                assert int((recon != 0).sum()) <= k
                assert torch.equal(l_new.reshape(-1), u - recon)
        state = new
    lhs = flat.tree_add(flat.tree_sub(world["tparams"], state.params),
                        flat.tree_map(lambda e: torch.mean(e, 0), state.ef))
    _close(lhs, _np(to_numpy(total_g)), rtol=1e-4, atol=1e-6)
