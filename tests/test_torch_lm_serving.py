"""Serving parity for every LM architecture of ``ARCH_IDS`` on the CPU:
prefill logits and caches and greedy decode steps against the JAX package
at each smoke config in f32; the mirror of tests/test_serving.py (decode =
forward over its five families, multi-step decode, the sliding-window
ring buffer; the enc-dec case is in tests/test_torch_encdec.py), with
recurrentgemma's ring wrapping and internvl2's prefix; the serving half of
tests/test_models_smoke.py over all ten; and the serve driver on each.
Tolerances in tests/_torch_families.py (2e-3 for the serving contract).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (B, CPU, DECODE_STEPS, FAMS, S, SERVE_TOL, T, TOL,
                             batch_of, cfg_of, close_trees, jcfg, np_tree,
                             port, reference, torch_batch)

from repro.models import build as jbuild
from repro.models.encdec import EncDec as JEncDec
from repro_torch.configs.base import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import build, layers
from repro_torch.models.encdec import EncDec

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _reference_serve(arch):
    """The reference's prefill of S tokens and DECODE_STEPS greedy decode
    steps: (prefill logits, cache, [(token fed, logits, cache)])."""
    jm, jp = reference(arch)
    batch = batch_of(arch, 4)
    toks = jnp.asarray(batch["tokens"])
    cache_len = S + DECODE_STEPS + get_smoke_config(arch).num_mm_tokens
    if isinstance(jm, JEncDec):
        logits, cache, t = jm.prefill(jp, jnp.asarray(batch["frames"]),
                                      toks, cache_len)
    else:
        logits, cache, t = jm.prefill(
            jp, toks, cache_len, None if "prefix_embeds" not in batch
            else jnp.asarray(batch["prefix_embeds"]))
    pre = (np.asarray(logits), np_tree(cache), int(t))
    steps = []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        logits, cache = jm.decode_step(jp, cache, tok, t + i)
        steps.append((np.asarray(tok), np.asarray(logits), np_tree(cache)))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return batch, cache_len, pre, steps


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_matchreference(arch):
    """Prefill logits and every cache leaf, then the decode steps fed the
    reference's greedy tokens (an argmax near-tie cannot flip them)."""
    batch, cache_len, (jlogits, jcache, jt), steps = _reference_serve(arch)
    model, tp = port(arch)
    tb = torch_batch(batch)
    if isinstance(model, EncDec):
        logits, cache, t = model.prefill(tp, tb["frames"], tb["tokens"],
                                         cache_len)
    else:
        logits, cache, t = model.prefill(tp, tb["tokens"], cache_len,
                                         tb.get("prefix_embeds"))
    assert t == jt and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    close_trees(cache, jcache)
    for i, (tok, jl, jc) in enumerate(steps):
        logits, cache = model.decode_step(tp, cache, torch.tensor(tok),
                                          t + i)
        np.testing.assert_allclose(logits.numpy(), jl, **TOL)
        close_trees(cache, jc)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "seamless-m4t-medium"])
def test_init_cache_matches_reference_layout(arch):
    jm, _ = reference(arch)
    model, _ = port(arch)
    close_trees(model.init_cache(B, 20, torch.float32),
                 np_tree(jm.init_cache(B, 20, jnp.float32)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the serving contract (tests/test_serving.py)
# ---------------------------------------------------------------------------


def _full_logits_at(model, params, tokens, pos):
    h, _ = model.forward_hidden(params, tokens)
    h = layers.rmsnorm(params["final_norm"], h, model.cfg.norm_eps)
    return model._logits(params, h[:, pos, :])


def _contract_model(arch, seed, **kw):
    cfg = cfg_of(arch, **kw)
    if cfg.num_experts:
        # the reference's test: capacity drops differ between the
        # teacher-forced forward (S tokens queueing) and decode (1 token)
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    model = build.build_model(cfg)
    jm = jbuild.build_model(jcfg(arch, **kw))
    params = params_from_numpy(np_tree(jm.init(jax.random.PRNGKey(seed))), CPU)
    tokens = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    return model, params, tokens


@pytest.mark.parametrize("arch", FAMS)
def test_decode_matches_forward(arch):
    model, params, tokens = _contract_model(arch, 0)
    with torch.no_grad():
        want = _full_logits_at(model, params, tokens, T - 1)
        _, cache, t0 = model.prefill(params, tokens[:, :T - 1], T + 2)
        got, _ = model.decode_step(params, cache, tokens[:, T - 1], t0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SERVE_TOL)


def test_multi_step_decode_matches_forward():
    model, params, tokens = _contract_model("tinyllama-1.1b", 1)
    prefix = 6
    with torch.no_grad():
        _, cache, t = model.prefill(params, tokens[:, :prefix], T + 2)
        for i in range(prefix, T):
            got, cache = model.decode_step(params, cache, tokens[:, i], t)
            t = t + 1
            want = _full_logits_at(model, params, tokens[:, :i + 1], i)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **SERVE_TOL)


def test_sliding_window_ring_buffer():
    """With attn_window = 4 a decode at position t equals attention over
    only the last 4 positions, from a ring of 4 slots."""
    model, params, tokens = _contract_model("tinyllama-1.1b", 2,
                                            attn_window=4)
    with torch.no_grad():
        want = _full_logits_at(model, params, tokens, T - 1)
        _, cache, t0 = model.prefill(params, tokens[:, :T - 1], T)
        assert cache["layers"]["0"].k.shape[2] == 4    # (L, B, win, KV, hd)
        got, _ = model.decode_step(params, cache, tokens[:, T - 1], t0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SERVE_TOL)


@pytest.mark.parametrize("prompt,cache_len", [(20, 16), (16, 16), (12, 30)])
def test_recurrentgemma_ring_wraps_over_its_window(prompt, cache_len):
    """recurrentgemma's local attention (smoke window 16) with a prompt
    longer than, equal to and shorter than the ring: the RG-LRU state and
    the conv buffer carry over, the attention ring wraps."""
    model, params, _ = _contract_model("recurrentgemma-2b", 3)
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (B, prompt + 1)).astype(np.int32))
    with torch.no_grad():
        want = _full_logits_at(model, params, tokens, prompt)
        _, cache, t0 = model.prefill(params, tokens[:, :prompt], cache_len)
        got, _ = model.decode_step(params, cache, tokens[:, prompt], t0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SERVE_TOL)


def test_vlm_prefix_serving_matches_forward():
    """internvl2's prefix embeddings carried through prefill: the decode of
    the last token equals the forward over prefix + tokens."""
    model, params, tokens = _contract_model("internvl2-1b", 4)
    cfg = model.cfg
    prefix = torch.tensor(np.random.default_rng(4).standard_normal(
        (B, cfg.num_mm_tokens, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        h, _ = model.forward_hidden(params, tokens, prefix)
        want = model._logits(params, layers.rmsnorm(
            params["final_norm"], h[:, -1, :], cfg.norm_eps))
        _, cache, t0 = model.prefill(params, tokens[:, :T - 1],
                                     T + 2 + cfg.num_mm_tokens, prefix)
        assert t0 == cfg.num_mm_tokens + T - 1
        got, _ = model.decode_step(params, cache, tokens[:, T - 1], t0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SERVE_TOL)


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py's serving case, and the serve driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_serving(arch):
    cfg = get_smoke_config(arch)
    model = build.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = torch_batch(batch_of(arch, 6))
    with torch.no_grad():
        if isinstance(model, EncDec):
            logits, cache, t0 = model.prefill(params, batch["frames"],
                                              batch["tokens"], S + 4)
        else:
            logits, cache, t0 = model.prefill(params, batch["tokens"], S + 4)
        assert logits.shape == (B, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        logits2, _ = model.decode_step(params, cache,
                                       torch.argmax(logits, -1), t0)
    assert logits2.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits2).all())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_main_on_every_arch(arch, capsys):
    """The serve driver's prefill and greedy decode on the CPU, an enc-dec
    model's frames from their own seed."""
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert capsys.readouterr().out.rstrip().endswith("serve OK")
    cfg = get_smoke_config(arch)
    assert res.model.cfg == cfg
    assert tuple(res.tokens.shape) == (2, 3)
    assert res.logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(res.logits).all())
    if cfg.enc_layers:
        assert tuple(res.frames.shape) == (2, cfg.num_mm_tokens, cfg.d_model)
    else:
        assert res.frames is None


def test_serve_defaults_to_tinyllama():
    res = serve.main(["--device", "cpu", "--gen", "2", "--batch", "1"])
    assert res.model.cfg.name == "tinyllama-1.1b"
