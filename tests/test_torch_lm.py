"""Port parity for the mamba2 LM serving path (``repro_torch.models.
transformer.LM``, ``repro_torch.models.build`` and the serve driver
``repro_torch.launch.serve``) on the CPU, at the smoke config in float32.

The JAX package's ``LM.init`` draws the weights and its jnp route
(``use_pallas_ssd=False``) is the reference; the port loads that tree
unchanged through ``convert.params_from_numpy`` and runs both of its
routes: ``ssd_scan`` and the kernel route (B4's plain version on the CPU).
Tolerance rtol 1e-4 / atol 1e-4, the bound of
tests/test_pallas_model_path.py; the two sides differ in summation order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_370m as jmamba
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models.build import build_model as jbuild_model
from repro_torch.configs import base as cbase
from repro_torch.configs import mamba2_370m
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import serve
from repro_torch.models.build import build_model
from repro_torch.models.transformer import LM

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH = 2
DECODE_STEPS = 4


def _cfg(use_pallas=False):
    return cbase.get_smoke_config("mamba2-370m").replace(
        dtype="float32", use_pallas_ssd=use_pallas)


@functools.lru_cache(maxsize=None)
def _reference():
    """(JAX model, JAX params): the smoke config in float32."""
    jcfg = jget_smoke_config("mamba2-370m").replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


def _port_params():
    _, jparams = _reference()
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _tokens(seq, seed=1):
    vocab = _cfg().vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, (BATCH, seq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve(seq):
    """The reference's prefill at ``seq`` and DECODE_STEPS greedy decode
    steps: (prefill logits, prefill cache, [(token fed, logits, cache)])."""
    jmodel, jparams = _reference()
    logits, cache, t = jax.jit(
        lambda p, tk: jmodel.prefill(p, tk, seq + DECODE_STEPS))(
            jparams, jnp.asarray(_tokens(seq)))
    pre = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    decode = jax.jit(jmodel.decode_step)
    steps = []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(DECODE_STEPS):
        logits, cache = decode(jparams, cache, tok, t + i)
        steps.append((np.asarray(tok), np.asarray(logits),
                      jax.tree.map(np.asarray, cache)))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return pre, steps


def _assert_trees_close(got, want, **tol):
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# configs and the parameter tree
# ---------------------------------------------------------------------------


def test_model_config_is_a_field_for_field_copy():
    """The reference's fields in its order with its defaults, then the
    port-only ones (``PORT_FIELDS``) at defaults that leave a config the
    reference's."""
    ours = [(f.name, f.default) for f in dataclasses.fields(cbase.ModelConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JModelConfig)]
    assert ours == ref + list(cbase.PORT_FIELDS.items())
    assert cbase.ModelConfig.__dataclass_fields__["use_pallas_ssd"].default \
        is False
    for ours_cfg, ref_cfg in ((mamba2_370m.CONFIG, jmamba.CONFIG),
                              (mamba2_370m.smoke_config(),
                               jmamba.smoke_config())):
        assert dataclasses.asdict(ours_cfg) == {
            **dataclasses.asdict(ref_cfg), **cbase.PORT_FIELDS}
    assert cbase.get_config("mamba2_370m") == mamba2_370m.CONFIG


def test_unknown_arch_and_block_raise():
    with pytest.raises(ValueError, match="unknown arch"):
        cbase.get_config("gpt-17")
    with pytest.raises(ValueError, match="unknown arch"):
        cbase.get_smoke_config("gpt-17")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="unknown block type"):
        LM(_cfg().replace(block_pattern=("mlp",))).init(gen)


def test_param_tree_matches_the_reference_layout():
    _, jparams = _reference()
    ours = LM(_cfg()).init(torch.Generator().manual_seed(0))
    got = [tuple(t.shape) for t in tree_leaves(ours)]
    want = [tuple(a.shape) for a in jax.tree.leaves(jparams)]
    assert got == want
    assert sorted(ours) == sorted(jparams) == ["embed", "final_norm",
                                               "layers"]
    assert sorted(ours["layers"]) == ["0"]
    assert ours["layers"]["0"]["ssm"]["in_proj"].shape[0] == 2   # n_periods


# ---------------------------------------------------------------------------
# forward, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_hidden_matches_reference(use_pallas):
    jmodel, jparams = _reference()
    tokens = _tokens(16, seed=2)
    jh, jaux = jmodel.forward_hidden(jparams, jnp.asarray(tokens))
    h, aux = build_model(_cfg(use_pallas)).forward_hidden(
        _port_params(), torch.from_numpy(tokens))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert float(aux) == float(jaux) == 0.0


# prompt lengths against ssm_chunk = 8: 16 is two chunks (kernel route,
# nc = 2), 4 and 5 a single chunk of the whole prompt (Q = S), 13 runs
# ssd_scan on both routes (13 does not divide by 8)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seq", [16, 4, 5, 13])
def test_prefill_matches_reference(seq, use_pallas):
    (jlogits, jcache), _ = _reference_serve(seq)
    model = build_model(_cfg(use_pallas))
    logits, cache, t = model.prefill(_port_params(),
                                     torch.from_numpy(_tokens(seq)),
                                     seq + DECODE_STEPS)
    assert t == seq and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    _assert_trees_close(cache, jcache, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_teacher_forced_decode_matches_reference(use_pallas):
    """4 decode steps after a 16-token prefill, both sides fed the
    reference's greedy tokens, so an argmax near-tie cannot flip the
    comparison."""
    _, steps = _reference_serve(16)
    model = build_model(_cfg(use_pallas))
    params = _port_params()
    _, cache, t = model.prefill(params, torch.from_numpy(_tokens(16)),
                                16 + DECODE_STEPS)
    for i, (tok, jlogits, jcache) in enumerate(steps):
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(np.array(tok)),
                                          t + i)
        np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
        _assert_trees_close(cache, jcache, **TOL)


def test_init_cache_matches_reference_layout():
    jmodel, _ = _reference()
    jcache = jmodel.init_cache(BATCH, 20, jnp.float32)
    cache = build_model(_cfg()).init_cache(BATCH, 20, torch.float32)
    _assert_trees_close(cache, jcache, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the serve driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--ssd-kernel", "--prompt-len", "16"],
    ["--ssd-kernel", "--prompt-len", "5", "--batch", "3", "--gen", "2"],
])
def test_serve_main_on_the_cpu(argv, capsys):
    res = serve.main(["--arch", "mamba2-370m", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serve OK")
    assert "prefill: batch=" in out and "decoded " in out
    assert bool(torch.isfinite(res.logits).all())
    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else 4
    gen = int(argv[argv.index("--gen") + 1]) if "--gen" in argv else 16
    assert tuple(res.tokens.shape) == (batch, gen)
    assert res.logits.shape == (batch, _cfg().vocab_size)
    assert res.prefill_s > 0 and res.decode_s >= 0


def test_serve_greedy_tokens_follow_the_logits():
    """The driver's tokens are the argmax of the model's own logits: the
    same params and prompt through prefill and decode_step by hand."""
    res = serve.main(["--arch", "mamba2-370m", "--device", "cpu", "--gen",
                      "3", "--batch", "2"])
    with torch.inference_mode():
        logits, cache, t = res.model.prefill(res.params, res.prompt, 35)
        tok = torch.argmax(logits, -1)
        toks = [tok]
        for i in range(2):
            logits, cache = res.model.decode_step(res.params, cache, tok,
                                                  t + i)
            tok = torch.argmax(logits, -1)
            toks.append(tok)
    assert torch.equal(torch.stack(toks, 1), res.tokens)
    assert torch.equal(logits, res.logits)


def test_serve_rejects_a_prompt_the_kernel_route_cannot_take():
    with pytest.raises(ValueError, match="does not divide"):
        serve.main(["--arch", "mamba2-370m", "--device", "cpu",
                    "--ssd-kernel", "--prompt-len", "13"])
    # an architecture with no SSM layer has no B4 route
    with pytest.raises(ValueError, match="no SSM layers"):
        serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                    "--ssd-kernel"])


def test_serve_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda"])


@pytest.mark.parametrize("seq,want", [(16, 2), (4, 2), (13, 0)])
def test_kernel_route_runs_once_per_layer_in_prefill_only(seq, want,
                                                          monkeypatch):
    """With ``use_pallas_ssd`` each SSM layer's prefill goes through the B4
    wrapper once (its plain version here), when the prompt divides by
    min(chunk, S); decode never does."""
    from repro_torch.kernels import ssd_chunk as ssd_mod
    calls = []
    plain = ssd_mod.ssd_chunk_plain
    monkeypatch.setattr(ssd_mod, "ssd_chunk_plain",
                        lambda *a: calls.append(1) or plain(*a))
    model = build_model(_cfg(True))
    params = _port_params()
    logits, cache, t = model.prefill(params, torch.from_numpy(_tokens(seq)),
                                     seq + 2)
    assert len(calls) == want
    model.decode_step(params, cache, torch.argmax(logits, -1), t)
    assert len(calls) == want
