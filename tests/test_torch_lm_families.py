"""Port parity for every LM architecture of ``ARCH_IDS`` on the CPU, at
each smoke config in f32 against the JAX package: the configs field for
field (the mirror of tests/test_configs.py over all ten), the parameter
trees' paths, shapes, dtypes and laws, loss and its gradient, and the
compressor's ``syn_loss`` and its gradient. Serving is in
tests/test_torch_lm_serving.py and training in
tests/test_torch_lm_families_fl.py; tolerances in tests/_torch_families.py
(rtol/atol 1e-4 for the model's numbers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (batch_of, cfg_of, close_trees, jax_batch, np_tree,
                             port, reference, torch_batch, value_and_grad)

from repro.configs import base as jbase
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core import flat as jflat
from repro.core import threesfc as jthreesfc
from repro.models import build as jbuild
from repro_torch.configs import base as cbase
from repro_torch.configs.base import (ARCH_IDS, CompressorConfig,
                                     get_smoke_config)
from repro_torch.convert import to_numpy
from repro_torch.core import flat, threesfc
from repro_torch.core.threesfc import SynData
from repro_torch.core.tree import tree_leaves
from repro_torch.models import build

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# configs (tests/test_configs.py) and the parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_get_config_equals_thereference(arch):
    """Field for field, the published config and the smoke config, by dash
    and underscore ids; the port-only fields at their defaults."""
    for ours, ref in ((cbase.get_config(arch), jbase.get_config(arch)),
                      (cbase.get_smoke_config(arch),
                       jbase.get_smoke_config(arch))):
        assert dataclasses.asdict(ours) == {**dataclasses.asdict(ref),
                                            **cbase.PORT_FIELDS}
    under = arch.replace("-", "_").replace(".", "_")
    assert cbase.get_config(under) == cbase.get_config(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_is_small_and_full_config_is_published(arch):
    """tests/test_configs.py's checks: the smoke variant is CPU-sized, the
    full one keeps the published widths and a citation."""
    smoke, full = cbase.get_smoke_config(arch), cbase.get_config(arch)
    assert smoke.d_model <= 512 and smoke.num_layers <= 5
    assert smoke.num_experts <= 4 and smoke.vocab_size <= 512
    assert full.source and full.name == arch
    if full.num_heads:
        assert full.num_heads % full.num_kv_heads == 0
        assert smoke.num_heads % smoke.num_kv_heads == 0
    if full.num_experts:
        assert full.experts_per_token <= full.num_experts


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_matches_thereference(arch):
    """The port's own init: the reference's paths, shapes and dtypes (so
    params_from_numpy loads a reference tree unchanged)."""
    _, jp = reference(arch)
    ours = build.build_model(cfg_of(arch)).init(
        torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda _: 0, to_numpy(ours)))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for t, (_, j) in zip(tree_leaves(ours), want):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    assert flat.tree_size(ours) == jflat.tree_size(jp)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "tinyllama-1.1b",
                                  "qwen3-moe-30b-a3b", "seamless-m4t-medium"])
def test_init_draws_the_reference_distributions(arch):
    """Same laws: per leaf, the port's draws have the reference's mean and
    spread (dense fan-in truncated normals, 0.02-scale embeddings, unit
    norm scales, zero biases) and a_param its exact values."""
    _, jp = reference(arch)
    ours = to_numpy(build.build_model(cfg_of(arch)).init(
        torch.Generator().manual_seed(0)))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(jp)):
        if a.size < 256:
            continue
        fa, fb = a[np.isfinite(a)], b[np.isfinite(b)]
        np.testing.assert_allclose(fa.std(), fb.std(), rtol=0.1, atol=1e-6)
        assert abs(fa.mean() - fb.mean()) <= 0.1 * fb.std() + 1e-6
    if "rec" in get_smoke_config(arch).block_pattern:
        a = ours["layers"]["0"]["rglru"]["a_param"]
        np.testing.assert_array_equal(
            a, jp["layers"]["0"]["rglru"]["a_param"])


# ---------------------------------------------------------------------------
# loss, gradient, syn_loss, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradient_matchreference(arch):
    jm, jp = reference(arch)
    model, tp = port(arch)
    batch = batch_of(arch)
    jl, jg = jax.value_and_grad(jm.loss)(jp, jax_batch(batch))
    loss, grads = value_and_grad(lambda w: model.loss(w, torch_batch(batch)), tp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    close_trees(grads, np_tree(jg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_syn_loss_and_gradient_matchreference(arch):
    """The compressor's F: soft input embeddings (behind ENC_SYN_LEN
    encoder frames for the enc-dec model), rank-8 soft labels; its value
    and ∇_w (an untied input embedding's gradient is zero on both sides)."""
    jm, jp = reference(arch)
    model, tp = port(arch)
    jcomp = JCompressorConfig(syn_seq=4, soft_label_rank=8)
    comp = CompressorConfig(syn_seq=4, soft_label_rank=8)
    jspec = jbuild.syn_spec_for(jm.cfg, jcomp)
    spec = build.syn_spec_for(model.cfg, comp)
    assert (spec.x_shape, spec.label_lead, spec.label_rank,
            spec.num_classes) == (jspec.x_shape, jspec.label_lead,
                                  jspec.label_rank, jspec.num_classes)
    syn = np_tree(jthreesfc.init_syn(jax.random.PRNGKey(3), jspec))
    jf = jbuild.syn_loss_fn(jm)
    jl, jg = jax.value_and_grad(jf)(jp, jthreesfc.SynData(
        *map(jnp.asarray, syn)))
    f = build.syn_loss_fn(model)
    tsyn = SynData(*[torch.tensor(a) for a in syn])
    loss, grads = value_and_grad(lambda w: f(w, tsyn), tp)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    close_trees(grads, np_tree(jg))


def test_unread_input_embedding_gets_a_zero_gradient():
    """An untied embedding is not read by syn_loss (soft embeddings go in
    straight): its ∇_w is zeros, as jax.grad reports it, so the encoder's
    trees keep the params' structure."""
    model, tp = port("tinyllama-1.1b")
    assert not model.cfg.tie_embeddings
    spec = build.syn_spec_for(model.cfg, CompressorConfig(syn_seq=4))
    syn = threesfc.init_syn(torch.Generator().manual_seed(0), spec)
    gw = threesfc.decode(build.syn_loss_fn(model), tp, syn, torch.ones(()))
    assert gw["embed"]["table"].shape == tp["embed"]["table"].shape
    assert not gw["embed"]["table"].any()
    assert gw["lm_head"]["w"].abs().sum() > 0
