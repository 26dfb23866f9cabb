"""Port parity for mamba2 LM training (``repro_torch.models.transformer.LM``
``loss`` and ``syn_loss``, ``repro_torch.models.build.syn_spec_for`` /
``syn_loss_fn`` and the 3SFC encoder through them) on the CPU, at the
smoke config in float32.

The JAX package's ``LM.init`` draws the weights and every input (tokens,
masks, prefix embeddings, D_syn, the target update) is drawn with numpy
and handed to both sides; the port loads the reference's tree unchanged
through ``convert.params_from_numpy``. Tolerance rtol 1e-4 / atol 1e-4,
the bound of tests/test_torch_lm.py and tests/test_pallas_model_path.py:
the two sides differ in summation order. The reference's ``LOSS_CHUNK``
(a module attribute read at call time) is monkeypatched to a small chunk
on both sides where a case needs more than one chunk.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.core import threesfc as jthreesfc
from repro.models import transformer as jtransformer
from repro.models.build import build_model as jbuild_model
from repro.models.build import syn_loss_fn as jsyn_loss_fn
from repro.models.build import syn_spec_for as jsyn_spec_for
from repro_torch.configs.base import CompressorConfig, get_smoke_config
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import threesfc
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.models import transformer
from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for
from repro_torch.models.transformer import LM

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 2


def _cfg(use_pallas=False):
    return get_smoke_config("mamba2-370m").replace(
        dtype="float32", use_pallas_ssd=use_pallas)


@functools.lru_cache(maxsize=None)
def _reference(seed=0):
    """(JAX model, JAX params): the smoke config in float32."""
    jcfg = jget_smoke_config("mamba2-370m").replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(seed))


def _port_params(seed=0):
    return params_from_numpy(jax.tree.map(np.asarray, _reference(seed)[1]),
                             CPU)


def _batch(seq, *, mask=False, prefix=0, seed=1):
    """A numpy batch: tokens, and optionally a 0/1 mask and prefix
    embeddings of ``prefix`` positions."""
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(
        np.int32)}
    if mask:
        out["mask"] = (rng.random((BATCH, seq)) < 0.7).astype(np.float32)
    if prefix:
        out["prefix_embeds"] = rng.standard_normal(
            (BATCH, prefix, cfg.d_model)).astype(np.float32)
    return out


def _port_value_and_grad(fn, params, *args):
    leaves, treedef = tree_flatten(params)
    w = [p.detach().requires_grad_(True) for p in leaves]
    v = fn(tree_unflatten(treedef, w), *args)
    return v.detach(), tree_unflatten(treedef, list(torch.autograd.grad(v,
                                                                        w)))


def _assert_trees_close(got, want, **tol):
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# LM.loss
# ---------------------------------------------------------------------------


# (seq, chunk): S - 1 under one chunk (15 < 512), then over a chunk of 4
# with a remainder (15 = 3·4 + 3) and without one (12 = 3·4)
@pytest.mark.parametrize("seq,chunk", [(16, 512), (16, 4), (13, 4)])
@pytest.mark.parametrize("mask", [False, True])
def test_loss_and_every_gradient_match_reference(seq, chunk, mask,
                                                 monkeypatch):
    monkeypatch.setattr(jtransformer, "LOSS_CHUNK", chunk)
    monkeypatch.setattr(transformer, "LOSS_CHUNK", chunk)
    jmodel, jparams = _reference()
    batch = _batch(seq, mask=mask)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_value_and_grad(build_model(_cfg()).loss,
                                       _port_params(), _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_trees_close(grads, jgrads, **TOL)


# the LM in bf16 (the published config's compute dtype) against its own
# f32 result: each gap within BF16_FACTOR times the gap the reference's
# bf16 run opens from the reference's f32 run on the same params and
# tokens (a CPU probe: hidden state 0.95-0.99x, gradient leaves 0.36-1.54x
# the reference's), and the hidden state's gap at least 1/BF16_FACTOR of
# the reference's, so the bf16 config does compute in bf16. The loss's gap
# (~1e-5: a mean over 126 positions that cancels) is held against the
# larger of the two draws' reference gaps (probe: 5.8e-5 and 5.1e-5
# against 1.4e-5 and 7.3e-5).
BF16_FACTOR = 2.0
BF16_SEQ = 64


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _dtype_gaps(seed):
    """((loss, hidden, [gradient leaves]) gaps of bf16 from f32) for the
    reference and for the port, on token draw ``seed``."""
    jparams = _reference()[1]
    tokens = _batch(BF16_SEQ, seed=seed)["tokens"]
    runs = {}
    for dt in ("float32", "bfloat16"):
        jmodel = jbuild_model(jget_smoke_config("mamba2-370m").replace(
            dtype=dt))
        jloss, jgrads = jax.value_and_grad(jmodel.loss)(
            jparams, {"tokens": jnp.asarray(tokens)})
        jh = jmodel.forward_hidden(jparams, jnp.asarray(tokens))[0]
        model = build_model(get_smoke_config("mamba2-370m").replace(
            dtype=dt))
        loss, grads = _port_value_and_grad(
            model.loss, _port_params(), {"tokens": torch.from_numpy(tokens)})
        with torch.no_grad():
            h = model.forward_hidden(_port_params(),
                                     torch.from_numpy(tokens))[0]
        runs[dt] = (
            (float(jloss), np.asarray(jh.astype(jnp.float32)),
             [np.asarray(g) for g in jax.tree.leaves(jgrads)]),
            (float(loss), h.float().numpy(),
             [g.float().numpy() for g in tree_leaves(grads)]))

    def gaps(side):
        (l32, h32, g32), (l16, h16, g16) = (runs["float32"][side],
                                            runs["bfloat16"][side])
        return (abs(l16 - l32) / abs(l32), _rel_l2(h16, h32),
                [_rel_l2(a, b) for a, b in zip(g16, g32)])

    return gaps(0), gaps(1)


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_lm_tracks_f32_within_the_reference_gap(seed):
    ref, port = _dtype_gaps(seed)
    assert ref[1] / BF16_FACTOR <= port[1] <= BF16_FACTOR * ref[1], \
        (port[1], ref[1])
    assert len(port[2]) == len(ref[2]) == 11
    for i, (p, r) in enumerate(zip(port[2], ref[2])):
        assert p <= BF16_FACTOR * r, f"gradient leaf {i}: {p:.3e} vs {r:.3e}"
    ref_loss = max(_dtype_gaps(s)[0][0] for s in (1, 2))
    assert port[0] <= BF16_FACTOR * ref_loss, (port[0], ref_loss)


def test_loss_masks_out_prefix_embeddings():
    """Prefix embeddings run through the trunk and stay out of the CE."""
    jmodel, jparams = _reference()
    batch = _batch(12, mask=True, prefix=3, seed=2)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_value_and_grad(build_model(_cfg()).loss,
                                       _port_params(), _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_trees_close(grads, jgrads, **TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_period_remat_changes_no_number(remat):
    """``cfg.remat`` (a checkpoint per period) trades memory for a
    recomputed forward: the loss and every gradient are bitwise those of
    the run that keeps its activations."""
    batch = _torch_batch(_batch(16, mask=True))
    params = _port_params()
    want = _port_value_and_grad(build_model(_cfg().replace(
        remat=False)).loss, params, batch)
    got = _port_value_and_grad(build_model(_cfg().replace(
        remat=remat)).loss, params, batch)
    assert torch.equal(got[0], want[0])
    for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert torch.equal(a, b)


def test_periods_are_taken_by_one_unbind_per_stacked_leaf():
    """Each stacked ``layers`` leaf reaches the loss through one
    ``torch.unbind`` (its backward: one ``stack``), never through a
    per-period index, whose backward would write a zero tensor of the
    whole stacked leaf once per period (48 x 862 MB for mamba2's in_proj
    at full width)."""
    cfg = _cfg().replace(num_layers=3, remat=False)
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    leaves, treedef = tree_flatten(params)
    w = [p.requires_grad_(True) for p in leaves]
    loss = LM(cfg).loss(tree_unflatten(treedef, w),
                        _torch_batch(_batch(16)))
    stacked = {id(t) for t in tree_leaves(tree_unflatten(treedef, w)[
        "layers"])}
    parents, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable"):
                parents.setdefault(id(nxt.variable), set()).add(node.name())
            todo.append(nxt)
    assert len(stacked) == 9
    for key in stacked:
        assert parents[key] == {"UnbindBackward0"}


# ---------------------------------------------------------------------------
# LM.syn_loss and the 3SFC encoder through it
# ---------------------------------------------------------------------------


def _specs(rank, syn_seq=4):
    jcomp = JCompressorConfig(syn_batch=1, syn_seq=syn_seq,
                              soft_label_rank=rank)
    comp = CompressorConfig(syn_batch=1, syn_seq=syn_seq,
                            soft_label_rank=rank)
    jspec = jsyn_spec_for(jget_smoke_config("mamba2-370m"), jcomp)
    spec = syn_spec_for(_cfg(), comp)
    return jspec, spec


@pytest.mark.parametrize("rank", [0, 8])
def test_syn_spec_matches_reference(rank):
    jspec, spec = _specs(rank)
    assert (spec.x_shape, spec.num_classes, spec.label_rank,
            spec.label_lead) == (jspec.x_shape, jspec.num_classes,
                                 jspec.label_rank, jspec.label_lead)
    assert spec.floats == jspec.floats


@pytest.mark.parametrize("rank", [0, 8])
def test_syn_spec_matches_reference_for_an_enc_dec_config(rank):
    """With ``enc_layers`` the payload's inputs take ENC_SYN_LEN encoder
    frames ahead of the decoder's positions; the labels cover the
    decoder's only."""
    comp = dict(syn_seq=4, soft_label_rank=rank)
    jspec = jsyn_spec_for(jget_smoke_config("mamba2-370m").replace(
        enc_layers=2), JCompressorConfig(**comp))
    spec = syn_spec_for(_cfg().replace(enc_layers=2), CompressorConfig(**comp))
    assert (spec.x_shape, spec.num_classes, spec.label_rank,
            spec.label_lead) == (jspec.x_shape, jspec.num_classes,
                                 jspec.label_rank, jspec.label_lead)
    assert spec.x_shape[1] == 8 + 4 and spec.floats == jspec.floats


def _syn0(rank, seed=3):
    jspec, _ = _specs(rank)
    syn = jthreesfc.init_syn(jax.random.PRNGKey(seed), jspec)
    return syn, threesfc.SynData(*[torch.from_numpy(np.array(t))
                                   for t in syn])


@pytest.mark.parametrize("rank", [0, 8])
def test_syn_loss_and_its_gradients_match_reference(rank):
    """The value, ∇_w and ∇ to each part of D_syn (dense labels, or the
    two low-rank factors)."""
    jmodel, jparams = _reference()
    jsyn, syn = _syn0(rank)
    jval, (jgw, jgs) = jax.value_and_grad(jmodel.syn_loss, argnums=(0, 1))(
        jparams, jsyn)
    model = build_model(_cfg())
    leaves, treedef = tree_flatten(_port_params())
    w = [p.requires_grad_(True) for p in leaves]
    sv = [t.clone().requires_grad_(True) for t in syn]
    val = model.syn_loss(tree_unflatten(treedef, w), threesfc.SynData(*sv))
    grads = torch.autograd.grad(val, w + sv, allow_unused=True)
    np.testing.assert_allclose(float(val.detach()), float(jval), **TOL)
    _assert_trees_close(tree_unflatten(treedef, list(grads[:len(w)])), jgw,
                        **TOL)
    for g, t, jg in zip(grads[len(w):], syn, jgs):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("rank", [0, 8])
def test_threesfc_encode_through_syn_loss_fn_matches_reference(rank):
    """``threesfc.encode`` with S = 2 grad-of-grad steps through the LM:
    the scalars (s, cosine, objective, the stats triple) and the trees
    (the final D_syn, ∇_w F and s·∇_w F)."""
    jmodel, jparams = _reference()
    target = jax.grad(jmodel.loss)(jparams, {"tokens": jnp.asarray(
        _batch(16)["tokens"])})
    jsyn, syn = _syn0(rank, seed=4)
    jres = jthreesfc.encode(jsyn_loss_fn(jmodel), jparams, target, jsyn,
                            steps=2, lr=0.1)
    res = threesfc.encode(syn_loss_fn(build_model(_cfg())), _port_params(),
                          params_from_numpy(jax.tree.map(np.asarray, target),
                                            CPU), syn, steps=2, lr=0.1)
    for got, want in ((res.s, jres.s), (res.cosine, jres.cosine),
                      (res.objective, jres.objective),
                      (res.stats, jres.stats)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(res.syn, jres.syn):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_trees_close(res.gw, jres.gw, **TOL)
    _assert_trees_close(res.recon, jres.recon, **TOL)


def test_threesfc_encode_through_the_kernel_route_raises():
    """C3: the encoder's grad-of-grad cannot run through B4's route, in the
    port as in the reference."""
    jcfg = jget_smoke_config("mamba2-370m").replace(use_pallas_ssd=True)
    jmodel = jbuild_model(jcfg)
    jparams = _reference()[1]
    # D_syn of 8 positions: the kernel route takes 8 = min(chunk 8, 8)
    jspec, _ = _specs(8, syn_seq=8)
    jsyn = jthreesfc.init_syn(jax.random.PRNGKey(5), jspec)
    syn = threesfc.SynData(*[torch.from_numpy(np.array(t)) for t in jsyn])
    target = jax.tree.map(jnp.ones_like, jparams)
    with pytest.raises(ValueError, match="Linearization failed"):
        jthreesfc.encode(jsyn_loss_fn(jmodel), jparams, target, jsyn,
                         steps=1)
    params = _port_params()
    with pytest.raises(RuntimeError, match="differentiable once"):
        threesfc.encode(syn_loss_fn(build_model(_cfg(True))), params,
                        tree_map(torch.ones_like, params), syn, steps=1)


# ---------------------------------------------------------------------------
# mirrors of tests/test_models_smoke.py (mamba2) and
# tests/test_pallas_model_path.py
# ---------------------------------------------------------------------------


def test_smoke_train_step():
    """tests/test_models_smoke.py::test_smoke_train_step for mamba2: a
    finite loss, finite non-zero grads, and one SGD step lowers the loss;
    on the reference's params and tokens, with the reference's loss and
    stepped loss beside."""
    jmodel, jparams = _reference()
    key = jax.random.PRNGKey(0)
    tokens = np.array(jax.random.randint(key, (BATCH, 16), 0,
                                         _cfg().vocab_size))
    jb = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(jparams, jb)
    jloss2 = jmodel.loss(jax.tree.map(lambda p, g: p - 0.05 * g, jparams,
                                      jgrads), jb)
    model = build_model(_cfg())
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = _port_value_and_grad(model.loss, _port_params(), batch)
    assert np.isfinite(float(loss))
    gn = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
    assert np.isfinite(float(gn)) and float(gn) > 0
    p2 = jax.tree.map(lambda p, g: p - 0.05 * g, _port_params(), grads)
    with torch.no_grad():
        loss2 = model.loss(p2, batch)
    assert float(loss2) < float(loss)
    np.testing.assert_allclose([float(loss), float(loss2)],
                               [float(jloss), float(jloss2)], **TOL)


def test_smoke_threesfc_encode():
    """tests/test_models_smoke.py::test_smoke_threesfc_encode for mamba2:
    grad-of-grad through the SSD scan is finite, and the server's decode
    is the client's reconstruction (rtol 1e-4 / atol 1e-6, the
    reference's bound)."""
    jmodel, jparams = _reference()
    key = jax.random.PRNGKey(0)
    tokens = np.array(jax.random.randint(key, (BATCH, 16), 0,
                                         _cfg().vocab_size))
    model = build_model(_cfg())
    _, grads = _port_value_and_grad(model.loss, _port_params(),
                                    {"tokens": torch.from_numpy(tokens)})
    comp = CompressorConfig(syn_batch=1, syn_seq=4)
    jspec = jsyn_spec_for(jget_smoke_config("mamba2-370m"),
                          JCompressorConfig(syn_batch=1, syn_seq=4))
    syn0 = threesfc.SynData(*[torch.from_numpy(np.array(t)) for t in
                              jthreesfc.init_syn(key, jspec)])
    assert syn_spec_for(_cfg(), comp).x_shape == jspec.x_shape
    lf = syn_loss_fn(model)
    res = threesfc.encode(lf, _port_params(), grads, syn0, steps=2, lr=0.1)
    assert np.isfinite(float(res.cosine)) and np.isfinite(float(res.s))
    server = threesfc.decode(lf, _port_params(), res.syn, res.s)
    for a, b in zip(tree_leaves(res.recon), tree_leaves(server)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_mamba2_pallas_path_matches_jnp():
    """tests/test_pallas_model_path.py::test_mamba2_pallas_path_matches_jnp:
    the kernel route's hidden states are the ssd_scan route's."""
    key = jax.random.PRNGKey(0)
    tokens = torch.from_numpy(np.asarray(jax.random.randint(
        key, (BATCH, 16), 0, _cfg().vocab_size)))
    params = _port_params()
    h1, _ = build_model(_cfg()).forward_hidden(params, tokens)
    h2, _ = build_model(_cfg(True)).forward_hidden(params, tokens)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), **TOL)


def test_mamba2_pallas_loss_and_grad():
    """tests/test_pallas_model_path.py::test_mamba2_pallas_loss_and_grad:
    value and grad through the kernel route are finite and non-zero; here
    also held to the reference's ssd_scan route on the same params."""
    jmodel, jparams = _reference(1)
    key = jax.random.PRNGKey(1)
    tokens = np.array(jax.random.randint(key, (BATCH, 16), 0,
                                         _cfg().vocab_size))
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {"tokens": jnp.asarray(tokens)})
    loss, grads = _port_value_and_grad(build_model(_cfg(True)).loss,
                                       _port_params(1),
                                       {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(loss))
    gn = sum(float(torch.sum(torch.abs(g))) for g in tree_leaves(grads))
    assert np.isfinite(gn) and gn > 0
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_trees_close(grads, jgrads, **TOL)
