"""Multi-head latent attention (``repro_torch.models.mla``) and the port-only
Moonlight architecture on the CPU.

MLA has no JAX twin: it is held to a plain loop over heads in f32 (every
head's q, its nope key and value from the normed latent, the shared
rotary key, a causal softmax, the sum of the heads' outputs through wo),
forward (rtol/atol 1e-5), gradient and grad-of-grad (rtol 1e-4, atol a
millionth of each tensor's largest entry): f32, the two differ by
summation order. Also: the architecture's registry entry
outside ``ARCH_IDS``, its parameter tree (the leading dense layer, the
held experts, 15,960,110,208 parameters at the published widths), a loss
with no auxiliary term, the sharding rules on its leaves (MLA replicates:
tensor parallelism for it is out of scope) and serving refusing its
block.
"""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base as cbase
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.models import build
from repro_torch.models import mla as mla_mod
from repro_torch.models import params as P_

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
D, H, KV, NOPE, ROPE, V = 32, 4, 16, 8, 4, 6


def _params(seed=0):
    p = mla_mod.mla_init(torch.Generator().manual_seed(seed), D, H, KV, NOPE,
                         ROPE, V)
    p["kv_norm"]["scale"] = 1.0 + 0.1 * torch.randn(
        KV, generator=torch.Generator().manual_seed(seed + 1))
    return p


def _rotate(t, pos, theta):
    """t (S, r): its two halves turned against each other by angle
    pos · theta^(-2i/r), written out."""
    r = t.shape[-1]
    inv = theta ** (-torch.arange(0, r, 2, dtype=torch.float32) / r)
    ang = pos[:, None].float() * inv
    a, b = t[:, :r // 2], t[:, r // 2:]
    return torch.cat([a * ang.cos() - b * ang.sin(),
                      b * ang.cos() + a * ang.sin()], -1)


def _loop(p, x, theta=50000.0, eps=1e-5):
    """MLA head by head for each sequence of x (B, S, D)."""
    outs = []
    for xs in x:
        S = xs.shape[0]
        pos = torch.arange(S)
        lat = xs @ p["wkv_a"]
        c, k_pe = lat[:, :KV], lat[:, KV:]
        c = c * torch.rsqrt(c.pow(2).mean(-1, keepdim=True) + eps) \
            * p["kv_norm"]["scale"]
        k_pe = _rotate(k_pe, pos, theta)
        y = torch.zeros(S, D)
        for h in range(H):
            q = xs @ p["wq"][:, h, :]
            q = torch.cat([q[:, :NOPE], _rotate(q[:, NOPE:], pos, theta)], -1)
            kv = c @ p["wkv_b"][:, h, :]
            k = torch.cat([kv[:, :NOPE], k_pe], -1)
            v = kv[:, NOPE:]
            logits = (q @ k.T) / math.sqrt(NOPE + ROPE)
            logits = logits.masked_fill(~torch.ones(S, S).tril().bool(),
                                        float("-inf"))
            y = y + torch.softmax(logits, -1) @ v @ p["wo"][h]
        outs.append(y)
    return torch.stack(outs)


def _mla(p, x):
    return mla_mod.mla(p, x, theta=50000.0, rope_dim=ROPE, eps=1e-5)


def test_mla_matches_the_per_head_loop():
    p = _params()
    x = torch.randn(2, 9, D, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(_mla(p, x).numpy(), _loop(p, x).numpy(),
                               **TOL)


def test_mla_gradients_of_both_orders_match_the_loop():
    """The gradient by x and every leaf, and the gradient of its squared
    norm (the 3SFC encode's grad-of-grad), against the loop's."""
    x0 = torch.randn(2, 7, D, generator=torch.Generator().manual_seed(4))

    def grads(fn):
        p = _params()
        leaves = [x0.clone().requires_grad_(True)] + [
            t.requires_grad_(True) for t in tree_leaves(p)]
        x = leaves[0]
        g = torch.autograd.grad(torch.sum(torch.sin(fn(p, x))), leaves,
                                create_graph=True)
        gg = torch.autograd.grad(sum(torch.sum(t * t) for t in g), leaves)
        return g + gg

    for a, b in zip(grads(_mla), grads(_loop)):
        b = b.detach().numpy()
        # the second order reaches 1e3: f32 order at that tensor's scale
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))


def test_mla_in_bf16_stays_near_f32():
    p = _params()
    x = torch.randn(1, 16, D, generator=torch.Generator().manual_seed(5))
    y = _mla(p, x.bfloat16())
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), _mla(p, x).numpy(),
                               rtol=2 ** -5, atol=2 ** -5)


# ---------------------------------------------------------------------------
# the architecture
# ---------------------------------------------------------------------------


def test_registry_resolves_the_port_only_architecture():
    cfg = cbase.get_config("moonlight-16b-a3b")
    assert cfg is cbase.get_config("moonlight_16b_a3b")
    assert "moonlight-16b-a3b" in cbase.PORT_ARCH_IDS
    assert "moonlight-16b-a3b" not in cbase.ARCH_IDS
    assert cbase.list_archs() == cbase.ARCH_IDS
    assert (cfg.num_layers, cfg.first_dense_layers, cfg.d_model,
            cfg.dense_d_ff, cfg.d_ff, cfg.num_experts,
            cfg.experts_per_token, cfg.shared_experts) == \
        (27, 1, 2048, 11264, 1408, 64, 6, 2)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.router, cfg.routed_scaling_factor) == \
        (512, 128, 64, 128, "sigmoid", 2.446)
    assert cfg.num_held_experts == 64
    smoke = cbase.get_smoke_config("moonlight-16b-a3b")
    assert smoke.num_held_experts == 4 and smoke.dtype == "float32"
    # the assignment twin keeps its own shape
    twin = cbase.get_config("moonshot-v1-16b-a3b")
    assert twin.num_layers == 48 and twin.router == "softmax"


def test_published_parameter_tree():
    """One dense lead layer, 26 stacked MoE periods of latent attention
    and 64 experts, untied head: 15,960,110,208 parameters."""
    model = build.build_model(cbase.get_config("moonlight-16b-a3b"))
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
    shapes = {"/".join(map(str, p)): tuple(t.shape)
              for p, t in tree_leaves_with_path(params)}
    assert P_.param_count(params) == 15_960_110_208
    assert shapes["lead/0/ffn/w_in"] == (2048, 11264)
    assert shapes["lead/0/mla/wq"] == (2048, 16, 192)
    assert shapes["layers/0/mla/wkv_a"] == (26, 2048, 576)
    assert shapes["layers/0/mla/wkv_b"] == (26, 512, 16, 256)
    assert shapes["layers/0/mla/wo"] == (26, 16, 128, 2048)
    assert shapes["layers/0/moe/w_in"] == (26, 64, 2048, 1408)
    assert shapes["layers/0/moe/score_bias"] == (26, 64)
    assert shapes["layers/0/moe/shared/w_in"] == (26, 2048, 2816)
    assert shapes["lm_head/w"] == (2048, 163840)
    held = cbase.get_config("moonlight-16b-a3b").replace(held_experts=8)
    with FakeTensorMode():
        cut = build.build_model(held).init(torch.Generator().manual_seed(0))
    assert tuple(cut["layers"]["0"]["moe"]["w_out"].shape) == \
        (26, 8, 1408, 2048)
    assert tuple(cut["layers"]["0"]["moe"]["router"].shape) == (26, 2048, 64)


def test_smoke_loss_has_no_auxiliary_term():
    """The dropless route adds no auxiliary loss: the trunk's aux is
    exactly zero and the loss is the chunked cross-entropy alone."""
    cfg = cbase.get_smoke_config("moonlight-16b-a3b")
    model = build.build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    h, aux = model.forward_hidden(p, tokens)
    assert float(aux) == 0.0
    logp = torch.log_softmax(model._logits(p, h[:, :-1]), -1)
    ce = -torch.gather(logp, -1, tokens[:, 1:, None]).mean()
    np.testing.assert_allclose(float(model.loss(p, {"tokens": tokens})),
                               float(ce), rtol=1e-6)
    leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
    g = torch.autograd.grad(model.loss(p, {"tokens": tokens}), leaves)
    assert all(torch.isfinite(t).all() for t in g)
    names = ["/".join(map(str, q)) for q, _ in tree_leaves_with_path(p)]
    assert not g[names.index("layers/0/moe/score_bias")].any()


def test_sharding_rules_take_the_new_leaves():
    """A model axis over the published tree: the latent attention's leaves
    and the selection bias replicate, the experts shard on their axis."""
    model = build.build_model(cbase.get_config("moonlight-16b-a3b"))
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
    specs = P_.sharding_specs(params, {"data": 2, "model": 4})
    got = {"/".join(map(str, p)): tuple(s)
           for p, s in tree_leaves_with_path(specs)}
    mla = {k: v for k, v in got.items() if "/mla/" in k or "score_bias" in k}
    assert mla and all(set(v) <= {None} for v in mla.values()), mla
    assert got["layers/0/moe/w_in"] == (None, "model", None, None)
    assert got["lm_head/w"] == (None, "model")


def test_serving_refuses_the_latent_attention_block():
    model = build.build_model(cbase.get_smoke_config("moonlight-16b-a3b"))
    with pytest.raises(NotImplementedError, match="no decode cache"):
        model.init_cache(1, 8, torch.float32)


def test_lead_layer_runs_ahead_of_the_periods_under_remat():
    """The lead block's forward is recomputed in the backward as the
    periods' are: one more ``mla.attention`` call for it in a training
    step than in a forward."""
    from repro_torch.obs import configure_tracer
    cfg = cbase.get_smoke_config("moonlight-16b-a3b")
    model = build.build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(2))
    tracer = configure_tracer(True)
    try:
        with torch.no_grad():
            model.loss(p, {"tokens": tokens})
        plain = [r["name"] for r in tracer.drain()]
        leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
        torch.autograd.grad(model.loss(p, {"tokens": tokens}), leaves)
        remat = [r["name"] for r in tracer.drain()]
    finally:
        configure_tracer(False)
    assert plain.count("mla.attention") == 3 and \
        plain.count("moe.routed") == 2
    assert remat.count("mla.attention") == 6 and \
        remat.count("moe.routed") == 4
