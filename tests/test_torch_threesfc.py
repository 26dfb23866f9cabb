"""Port parity for the 3SFC encoder/decoder (``repro_torch.core.threesfc``)
at the full width of the paper's MLP (d = 199,210), on the CPU.

The reference (``repro.core.threesfc``, Pallas in interpret mode) draws the
params, the target update and ``syn0``; the port starts from the same
numbers, carried across as numpy. Then the port's own properties mirror
tests/test_threesfc.py: Eq. 8 optimality, Eq. 10 decode exactness, cosine
rising with steps, and EF reducing the error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core import flat as jflat
from repro.core import threesfc as jthreesfc
from repro.data.synthetic import make_class_image_dataset as jdataset
from repro.models.build import vision_syn_spec as jsyn_spec
from repro.models.cnn import MNIST_SPEC as JMNIST
from repro.models.cnn import make_paper_model as jmodel
from repro_torch.configs.base import CompressorConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat, threesfc
from repro_torch.core.strategy import make_strategy
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import MNIST_SPEC, make_mlp

torch.set_num_threads(2)

CPU = torch.device("cpu")
STEPS = 3
# The two sides differ only in summation order (XLA's vs PyTorch's CPU
# matmuls and reductions, ~1e-7 relative per op); S=3 grad-of-grad steps
# carry that through, so the scalars are held to 1e-5 relative and the
# trees to 1e-4 relative, with an absolute floor of 1e-5 of the tree's
# largest element for entries that cancel to near zero.
SCALAR_TOL = dict(rtol=1e-5, atol=1e-7)
TREE_RTOL, TREE_ATOL_OF_MAX = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _syn_to_torch(syn):
    return threesfc.SynData(*[torch.from_numpy(np.array(t)) for t in syn])


@pytest.fixture(scope="module")
def world():
    """Reference params, a 3-step local-training target and spec."""
    model = jmodel("mlp", JMNIST)
    params = model.init(jax.random.PRNGKey(0))
    ds = jdataset(jax.random.PRNGKey(1), 256, (28, 28, 1), 10)
    p = params
    for i in range(3):
        g = jax.grad(model.loss)(p, {"x": jnp.asarray(ds.x[i * 64:(i + 1) * 64]),
                                     "y": jnp.asarray(ds.y[i * 64:(i + 1) * 64])})
        p = jax.tree.map(lambda a, b: a - 0.01 * b, p, g)
    target = jflat.tree_sub(params, p)
    jspec = jsyn_spec(JMNIST, JCompressorConfig(syn_batch=1))
    tmodel = make_mlp(MNIST_SPEC)
    tspec = vision_syn_spec(MNIST_SPEC, CompressorConfig(syn_batch=1))
    return {"jmodel": model, "params": params, "target": target,
            "jspec": jspec, "tmodel": tmodel, "tspec": tspec,
            "tparams": params_from_numpy(_np(params), CPU),
            "ttarget": params_from_numpy(_np(target), CPU)}


@pytest.fixture(scope="module")
def encoded(world):
    """One S=3 encode on both sides from the reference's syn0."""
    syn0 = jthreesfc.init_syn(jax.random.PRNGKey(2), world["jspec"])
    ref = jthreesfc.encode(world["jmodel"].syn_loss, world["params"],
                           world["target"], syn0, steps=STEPS, lr=0.1)
    got = threesfc.encode(world["tmodel"].syn_loss, world["tparams"],
                          world["ttarget"], _syn_to_torch(syn0),
                          steps=STEPS, lr=0.1)
    return ref, got


def _close_trees(got, want, **tol):
    """Leaf by leaf, in tree order (the two SynData types differ)."""
    g_leaves = jax.tree.leaves(to_numpy(tuple(got)) if isinstance(got, tuple)
                               else to_numpy(got))
    w_leaves = jax.tree.leaves(_np(want))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, w, **tol)


def test_mlp_has_paper_width(world):
    assert flat.tree_size(world["tparams"]) == 199210
    shapes = {k: {n: tuple(v.shape) for n, v in d.items()}
              for k, d in make_mlp(MNIST_SPEC).init(
                  torch.Generator().manual_seed(0)).items()}
    assert shapes == {k: {n: v.shape for n, v in d.items()}
                      for k, d in world["params"].items()}


@pytest.mark.parametrize("field", ["s", "cosine", "objective", "stats"])
def test_encode_scalars_match_reference(encoded, field):
    ref, got = encoded
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(ref, field)), **SCALAR_TOL)


@pytest.mark.parametrize("field", ["gw", "syn"])
def test_encode_trees_match_reference(encoded, field):
    ref, got = encoded
    want = getattr(ref, field)
    scale = max(float(np.max(np.abs(l), initial=0.0))
                for l in jax.tree.leaves(_np(want)))
    _close_trees(getattr(got, field), want, rtol=TREE_RTOL,
                 atol=TREE_ATOL_OF_MAX * scale)


def test_decode_matches_reference_recon(world, encoded):
    """The port's server decode from (D_syn, s) equals the reference
    encoder's reconstruction (and the port's own, Eq. 10)."""
    ref, got = encoded
    recon = threesfc.decode(world["tmodel"].syn_loss, world["tparams"],
                            got.syn, got.s)
    _close_trees(recon, ref.recon, rtol=1e-4, atol=1e-9)
    _close_trees(recon, got.recon, rtol=1e-5, atol=1e-9)


def test_scale_is_least_squares_optimal(world, encoded):
    """Eq. 8: s* minimizes ‖s·∇F − target‖²; any other s is worse."""
    _, res = encoded
    gw = threesfc.decode(world["tmodel"].syn_loss, world["tparams"],
                         res.syn, torch.tensor(1.0))

    def err(s):
        return float(flat.tree_sqnorm(flat.tree_sub(flat.tree_scale(gw, s),
                                                    world["ttarget"])))

    s_star = float(res.s)
    e_star = err(s_star)
    for ds in (-0.5, -0.1, 0.1, 0.5):
        assert err(s_star * (1 + ds) + 1e-3 * ds) >= e_star - 1e-10


def test_encoder_steps_improve_cosine(world):
    gen = torch.Generator().manual_seed(4)
    syn0 = threesfc.init_syn(gen, world["tspec"])
    cs = []
    for steps in (1, 5, 15):
        res = threesfc.encode(world["tmodel"].syn_loss, world["tparams"],
                              world["ttarget"], syn0, steps=steps, lr=0.1)
        cs.append(abs(float(res.cosine)))
    assert cs[-1] > cs[0], f"cosine did not improve with steps: {cs}"


def test_encode_cosine_matches_recon_cosine(encoded, world):
    """res.cosine (from the fused triple via the sign trick) equals a direct
    tree_cosine of the materialized recon."""
    _, res = encoded
    want = flat.tree_cosine(res.recon, world["ttarget"])
    np.testing.assert_allclose(float(res.cosine), float(want), rtol=1e-5,
                               atol=1e-7)


def test_init_syn_shapes_and_budget(world):
    gen = torch.Generator().manual_seed(6)
    syn = threesfc.init_syn(gen, world["tspec"])
    assert syn.floats == world["tspec"].floats == 28 * 28 * 1 + 10
    assert tuple(syn.y_rank.shape) == (0, 0)
    spec = threesfc.SynSpec(x_shape=(1, 8, 32), num_classes=1000,
                            label_rank=4, label_lead=(1, 8))
    syn = threesfc.init_syn(gen, spec)
    assert tuple(syn.labels().shape) == (1, 8, 1000)
    assert spec.floats == jthreesfc.SynSpec(
        x_shape=(1, 8, 32), num_classes=1000, label_rank=4,
        label_lead=(1, 8)).floats


def test_threesfc_with_ef_reduces_error(world):
    """EF residual shrinks the effective error over rounds: cumulative
    reconstruction tracks the cumulative target."""
    cfg = CompressorConfig(kind="threesfc", syn_steps=5, syn_lr=0.1)
    strat = make_strategy(cfg, loss_fn=world["tmodel"].syn_loss,
                          syn_spec=world["tspec"])
    params, target = world["tparams"], world["ttarget"]
    e = strat.init_ef_state(params)
    tot = flat.tree_zeros_like(e)
    gen = torch.Generator().manual_seed(7)
    rel = []
    for t in range(4):
        recon, e, _ = strat.step(gen, target, e, params)
        tot = flat.tree_add(tot, recon)
        want = flat.tree_scale(target, float(t + 1))
        rel.append(float(flat.tree_norm(flat.tree_sub(tot, want))
                         / flat.tree_norm(want)))
    assert rel[-1] <= rel[0] + 1e-6, rel


def test_payload_budget_matches_reference(world):
    from repro.fl.budget import payload_budget as jbudget
    from repro_torch.fl.budget import matched_compressors, payload_budget
    assert payload_budget("mlp", MNIST_SPEC) == jbudget("mlp", JMNIST) == 795.0
    table = matched_compressors("mlp", MNIST_SPEC, 199210)
    assert sorted(table) == ["dgc", "fedavg", "signsgd", "stc", "threesfc"]
    assert table["threesfc"].syn_steps == 10
    strat = make_strategy(table["threesfc"], loss_fn=world["tmodel"].syn_loss,
                          syn_spec=world["tspec"])
    assert strat.payload_floats(world["tparams"]) == 795.0


def test_strategy_decode_aggregate_and_mask(world, encoded):
    """server_decode of one payload is the encoder's recon; the fused
    aggregate of two copies with scales (s, -s) cancels; masking scales s."""
    _, res = encoded
    cfg = CompressorConfig(kind="threesfc", syn_steps=STEPS)
    strat = make_strategy(cfg, loss_fn=world["tmodel"].syn_loss,
                          syn_spec=world["tspec"])
    _close_trees(strat.server_decode((res.syn, res.s), world["tparams"]),
                 to_numpy(res.recon), rtol=1e-5, atol=1e-9)
    syns = threesfc.SynData(*[torch.stack([t, t]) for t in res.syn])
    one = strat.server_aggregate(world["tparams"],
                                 (syns, torch.stack([res.s, res.s])))
    _close_trees(one, to_numpy(res.recon), rtol=1e-5, atol=1e-9)
    zero = strat.server_aggregate(world["tparams"],
                                  (syns, torch.stack([res.s, -res.s])))
    assert float(flat.tree_norm(zero)) < 1e-9
    _, ss = strat.mask_payloads((syns, torch.stack([res.s, res.s])),
                                torch.tensor([1.0, 0.0]))
    np.testing.assert_array_equal(ss.numpy(), [float(res.s), 0.0])


def test_strategy_registry_and_unported_paths(world):
    from repro_torch.core import strategy as S
    assert S.strategy_kinds() == ["fedsynth", "identity", "randk", "signsgd",
                                  "stc", "threesfc", "topk"]
    with pytest.raises(ValueError, match="already registered"):
        S.register_strategy("threesfc")(type("Dup", (S.CompressionStrategy,),
                                             {}))
    with pytest.raises(ValueError, match="unknown compressor kind"):
        make_strategy(CompressorConfig(kind="dgc"))
    # the accounted-only methods have no wire codec; fedsynth no server
    # decode and no fused aggregate, as in the reference
    fcfg = CompressorConfig(kind="fedsynth")
    fedsynth = make_strategy(fcfg, loss_fn=world["tmodel"].syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, fcfg))
    for strat in (make_strategy(CompressorConfig(kind="randk")), fedsynth):
        with pytest.raises(KeyError, match="no wire codec"):
            strat.wire_codec(world["tparams"])
    assert not fedsynth.supports_fused_aggregate
    with pytest.raises(NotImplementedError, match="no payload decode"):
        fedsynth.server_decode(None, world["tparams"])
    with pytest.raises(NotImplementedError, match="fused aggregation"):
        fedsynth.server_aggregate(world["tparams"], None)
    ident = make_strategy(CompressorConfig(kind="identity",
                                           error_feedback=False))
    codec = ident.wire_codec(world["tparams"])
    assert codec.kind == "identity" and codec.strategy is ident
    buf, e, m = ident.wire_step(None, world["ttarget"], world["ttarget"],
                                world["tparams"], codec=codec)
    assert buf.dtype == torch.uint8 and buf.numel() == codec.nbytes
    assert e is world["ttarget"] and float(m.cosine) == 1.0
    with pytest.raises(ValueError, match="fused"):
        from repro_torch.configs.base import FLConfig
        from repro_torch.configs.run import RunConfig
        from repro_torch.fl.round import build_fl_round
        build_fl_round(world["tmodel"].loss, ident,
                       RunConfig(fl=FLConfig(), fused_decode=True))


def test_recon_is_colinear_with_syn_grad(world):
    """recon = s·∇F lies on the syn-grad ray: |cos(recon, ∇F)| == 1."""
    syn0 = threesfc.init_syn(torch.Generator().manual_seed(5),
                             world["tspec"])
    res = threesfc.encode(world["tmodel"].syn_loss, world["tparams"],
                          world["ttarget"], syn0, steps=1, lr=0.1)
    gw = threesfc.decode(world["tmodel"].syn_loss, world["tparams"],
                         res.syn, torch.tensor(1.0))
    assert abs(abs(float(flat.tree_cosine(res.recon, gw))) - 1.0) < 1e-5


def test_encode_aux_matches_fresh_objective(world):
    """The (objective, gw, stats) the encoder returns equal a fresh
    ``_objective`` evaluation at the returned D_syn."""
    syn0 = threesfc.init_syn(torch.Generator().manual_seed(8),
                             world["tspec"])
    res = threesfc.encode(world["tmodel"].syn_loss, world["tparams"],
                          world["ttarget"], syn0, steps=2, lr=0.1)
    w = flat.tree_map(lambda p: p.detach().requires_grad_(True),
                      world["tparams"])
    val, (gw, st) = threesfc._objective(world["tmodel"].syn_loss, w,
                                        res.syn, world["ttarget"], 0.0)
    np.testing.assert_allclose(float(res.objective), float(val), rtol=1e-6)
    np.testing.assert_allclose(res.stats.numpy(), st.detach().numpy(),
                               rtol=1e-5)
    for a, b in zip(flat.tree_leaves(res.gw), flat.tree_leaves(gw)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-8)


def test_low_rank_labels():
    """``init_syn`` with a label rank draws the factors u (lead, r) and
    v (r, C); the dense labels are u·v; the budget counts both factors, as
    the reference's spec does."""
    spec = threesfc.SynSpec(x_shape=(1, 8, 32), num_classes=1000,
                            label_rank=4, label_lead=(1, 8))
    syn = threesfc.init_syn(torch.Generator().manual_seed(0), spec)
    assert tuple(syn.y.shape) == (1, 8, 4)
    assert tuple(syn.y_rank.shape) == (4, 1000)
    assert tuple(syn.labels().shape) == (1, 8, 1000)
    assert spec.floats == 1 * 8 * 32 + 1 * 8 * 4 + 4 * 1000
    assert syn.floats == spec.floats
    # a 4-term f32 sum of products of 0.1-scale draws: a few f32 roundings
    # of 1e-2 terms, so atol 1e-8 for sums that cancel to near zero
    np.testing.assert_allclose(
        syn.labels().numpy(),
        np.einsum("abr,rc->abc", syn.y.numpy(), syn.y_rank.numpy()),
        rtol=1e-6, atol=1e-8)
