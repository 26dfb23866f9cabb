"""Port parity for the encoder-decoder model (``repro_torch.models.encdec``
and its ``models.build`` branch) on the CPU, against the JAX package's
``models/encdec.py`` at seamless-m4t-medium's smoke config in f32.

The reference draws the params; the port loads them through
``params_from_numpy``. Frames and tokens are drawn from a seed with numpy.
Tolerance rtol/atol 1e-4 for the model's numbers (tests/test_torch_lm.py's
block bound) and 2e-3 for the serving contract, as tests/test_serving.py.
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
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro_torch.configs.base import CompressorConfig, get_smoke_config
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import threesfc
from repro_torch.core.threesfc import SynData
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.models import build, layers
from repro_torch.models.encdec import EncDec

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "seamless-m4t-medium"
B, T = 2, 12


@functools.lru_cache(maxsize=None)
def _reference():
    jcfg = jget_smoke_config(ARCH).replace(dtype="float32")
    jmodel = jbuild.build_model(jcfg)
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def _port():
    _, jp = _reference()
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    return build.build_model(cfg), params_from_numpy(
        jax.tree.map(np.asarray, jp), CPU)


def _inputs(seed=1, t=T):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.num_mm_tokens, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    return frames, tokens


def _close_trees(got, want, **tol):
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


def test_build_model_gives_the_enc_dec_facade():
    model, _ = _port()
    assert isinstance(model, EncDec)
    with pytest.raises(ValueError, match="enc_layers"):
        EncDec(get_smoke_config("tinyllama-1.1b"))


def test_param_tree_matches_the_reference_layout():
    """Keys, shapes and dtypes, leaf by leaf (enc_layers, dec_layers with
    xattn and lnx, enc_norm, lm_head)."""
    _, jp = _reference()
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    ours = EncDec(cfg).init(torch.Generator().manual_seed(0))
    assert sorted(ours) == sorted(jp)
    assert sorted(ours["dec_layers"]) == sorted(jp["dec_layers"])
    flat_ours = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(0), to_numpy(ours)))[0]
    paths = [jax.tree_util.keystr(p) for p, _ in flat_ours]
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert paths == [jax.tree_util.keystr(p) for p, _ in want]
    for t, (_, j) in zip(tree_leaves(ours), want):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def test_encode_matches_reference():
    jm, jp = _reference()
    model, tp = _port()
    frames, _ = _inputs()
    _close_trees(model.encode(tp, torch.from_numpy(frames)),
                 jm.encode(jp, jnp.asarray(frames)))


@pytest.mark.parametrize("t", [12, 5])
def test_loss_and_gradient_match_reference(t):
    jm, jp = _reference()
    model, tp = _port()
    frames, tokens = _inputs(2, t)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    leaves, treedef = tree_flatten(tp)
    w = [p.requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(treedef, w),
                      {"frames": torch.from_numpy(frames),
                       "tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, w)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _close_trees(tree_unflatten(treedef, list(grads)), jg)


def test_loss_divides_by_every_position():
    """B·(S−1) in the denominator, no mask: twice the batch of the same
    rows gives the same loss."""
    model, tp = _port()
    frames, tokens = _inputs(3)
    one = model.loss(tp, {"frames": torch.from_numpy(frames),
                          "tokens": torch.from_numpy(tokens)})
    two = model.loss(tp, {"frames": torch.from_numpy(np.concatenate(
        [frames, frames])), "tokens": torch.from_numpy(np.concatenate(
            [tokens, tokens]))})
    np.testing.assert_allclose(float(two), float(one), rtol=1e-6)


@pytest.mark.parametrize("rank", [0, 4])
def test_syn_spec_and_syn_loss_match_reference(rank):
    """ENC_SYN_LEN encoder frames ahead of the decoder's soft embeddings;
    syn_loss_fn binds the encoder length."""
    jm, jp = _reference()
    model, tp = _port()
    kw = dict(syn_seq=4, soft_label_rank=rank)
    jspec = jbuild.syn_spec_for(jm.cfg, JCompressorConfig(**kw))
    spec = build.syn_spec_for(model.cfg, CompressorConfig(**kw))
    assert build.ENC_SYN_LEN == jbuild.ENC_SYN_LEN == 8
    assert spec.x_shape == jspec.x_shape == (1, 12, model.cfg.d_model)
    assert (spec.label_lead, spec.label_rank, spec.num_classes) == (
        jspec.label_lead, jspec.label_rank, jspec.num_classes)
    syn = jax.tree.map(np.asarray, jthreesfc.init_syn(
        jax.random.PRNGKey(4), jspec))
    want = jbuild.syn_loss_fn(jm)(jp, jthreesfc.SynData(
        *map(jnp.asarray, syn)))
    got = build.syn_loss_fn(model)(tp, SynData(*[torch.tensor(a)
                                                 for a in syn]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_threesfc_encode_through_syn_loss_matches_reference():
    """Grad-of-grad through the encoder, cross-attention and decoder: the
    encode's cosine and scale, and the server's decode exact."""
    jm, jp = _reference()
    model, tp = _port()
    frames, tokens = _inputs(5)
    batch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    jg = jax.grad(jm.loss)(jp, batch)
    comp = dict(syn_seq=4, soft_label_rank=4)
    jspec = jbuild.syn_spec_for(jm.cfg, JCompressorConfig(**comp))
    syn0 = jax.tree.map(np.asarray, jthreesfc.init_syn(jax.random.PRNGKey(6),
                                                       jspec))
    jres = jthreesfc.encode(jbuild.syn_loss_fn(jm), jp, jg,
                            jthreesfc.SynData(*map(jnp.asarray, syn0)),
                            steps=2, lr=0.1)
    target = params_from_numpy(jax.tree.map(np.asarray, jg), CPU)
    lf = build.syn_loss_fn(model)
    res = threesfc.encode(lf, tp, target,
                          SynData(*[torch.tensor(a) for a in syn0]), steps=2,
                          lr=0.1)
    np.testing.assert_allclose(float(res.cosine), float(jres.cosine),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(res.s), float(jres.s), rtol=1e-3)
    server = threesfc.decode(lf, tp, res.syn, res.s)
    for a, b in zip(tree_leaves(res.recon), tree_leaves(server)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_init_cache_matches_reference_layout():
    jm, _ = _reference()
    model, _ = _port()
    want = jm.init_cache(B, 20, 8, jnp.float32)
    got = model.init_cache(B, 20, 8, torch.float32)
    _close_trees(got, want, rtol=0, atol=0)


def test_prefill_and_decode_steps_match_reference():
    """Prefill (self-attention ring, the projected memory K/V once per
    layer), then 3 decode steps fed the reference's greedy tokens; the
    cross-attention query takes no bq (biases drawn non-zero here)."""
    cfg = get_smoke_config(ARCH).replace(dtype="float32", qkv_bias=True)
    jm = jbuild.build_model(jget_smoke_config(ARCH).replace(
        dtype="float32", qkv_bias=True))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for block in ("attn", "xattn"):
        for b in ("bq", "bk", "bv"):
            leaf = jp["dec_layers"][block][b]
            jp["dec_layers"][block][b] = (
                0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
    model = build.build_model(cfg)
    tp = params_from_numpy(jp, CPU)
    frames, tokens = _inputs(8)
    jl, jc, jt = jm.prefill(jp, jnp.asarray(frames), jnp.asarray(tokens),
                            T + 3)
    logits, cache, t = model.prefill(tp, torch.from_numpy(frames),
                                     torch.from_numpy(tokens), T + 3)
    assert t == int(jt) == T
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _close_trees(cache, jc)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for i in range(3):
        jl, jc = jm.decode_step(jp, jc, tok, jt + i)
        logits, cache = model.decode_step(
            tp, cache, torch.from_numpy(np.asarray(tok)), t + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        _close_trees(cache, jc)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)


def test_encdec_decode_consistency():
    """tests/test_serving.py::test_encdec_decode_consistency: the decode
    of token T-1 after a prefill of T-1 equals the teacher-forced
    decoder's logits at T-1."""
    model, tp = _port()
    frames, tokens = _inputs(9)
    frames, tokens = torch.from_numpy(frames), torch.from_numpy(tokens)
    memory = model.encode(tp, frames)
    x = layers.embed(tp["embed"], tokens, model.dtype)
    h = model._decoder_hidden(tp, x, memory)
    want = layers.lm_head(tp["lm_head"], h[:, -1, :])
    _, cache, t0 = model.prefill(tp, frames, tokens[:, :T - 1], T + 2)
    got, _ = model.decode_step(tp, cache, tokens[:, T - 1], t0)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **SERVE_TOL)
    # and the reference's teacher-forced logits, within the block bound
    jm, jp = _reference()
    jmem = jm.encode(jp, jnp.asarray(frames.numpy()))
    jh = jm._decoder_hidden(jp, jlayers.embed(
        jp["embed"], jnp.asarray(tokens.numpy()), jm.dtype), jmem)
    np.testing.assert_allclose(
        want.detach().numpy(),
        np.asarray(jlayers.lm_head(jp["lm_head"], jh[:, -1, :])), **TOL)
