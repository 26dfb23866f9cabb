"""Kernel B7 (``kernels/causal_attention.py``) on a CUDA card, against its
plain version on the same card; skipped where no card is visible.

Shapes are the main path's: qwen1.5-0.5b's attention (16 heads of 64, one
KV head each) and Moonlight's latent attention (16 heads, q·k of 192, v of
128 read through a strided view, as ``models/mla.py`` hands it over), at
S = 4,096; tinyllama-1.1b's (32 heads of 64 over 4 KV heads, G = 8); and
a grouped case (G = 2) whose S is no multiple of a tile.

**Tolerance.** Kernel and plain version round at the same points, but sum
in other orders: the tensor cores' products against cuBLAS's, and l over
other partial sums. A bf16 output then differs by one unit in its last
place wherever the two f32 sums straddle a rounding boundary, and a
probability rounded to bf16 the other way moves the sums after it. So
each output of the kernel is held to its distance from the exact answer
(the plain version on the same bf16 values in f32): at most twice the
plain bf16 version's own distance from it, plus 1e-5 of the output's
scale, in the max and in the mean.
"""
import pytest
import torch

from repro_torch.kernels import causal_attention as flash
from repro_torch.models import attention as attn

# (B, S, H, KV, D, DV, v a strided view)
SHAPES = {
    "qwen": (1, 4096, 16, 16, 64, 64, False),
    "moonlight": (1, 4096, 16, 16, 192, 128, True),
    "tinyllama": (1, 4096, 32, 4, 64, 64, False),
    "grouped_ragged": (2, 1000, 8, 4, 128, 128, False),
}


@pytest.fixture
def card():
    """The card, decided when the test runs; skips where none is
    visible."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel B7 has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, shape, seed=0):
    B, S, H, KV, D, DV, strided = shape
    g = torch.Generator(device=card).manual_seed(seed)

    def draw(*s):
        return torch.randn(s, generator=g, device=card).to(torch.bfloat16)

    q, k = draw(B, S, H, D), draw(B, S, KV, D)
    if strided:  # v the second half of a (.., D + DV) projection, as MLA's
        v = draw(B, S, KV, D + DV)[..., D:]
    else:
        v = draw(B, S, KV, DV)
    do = draw(B, S, H, DV)
    return q, k, v, do


def _both(q, k, v, do, scale):
    """(o, dq, dk, dv) of the kernels and of the plain version."""
    o, m, l = flash._forward(q, k, v, scale)
    grads = flash._backward(q, k, v, do, m, l, scale)
    po, pm, pl = flash.causal_attention_plain(q, k, v, scale)
    pgrads = flash.causal_attention_plain_backward(q, k, v, do, pm, pl,
                                                   scale)
    return (o, *grads), (po, *pgrads)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
def test_card_kernel_matches_plain(shape, card):
    q, k, v, do = _inputs(card, SHAPES[shape])
    scale = attn._scale(q.shape[-1])
    got, plain = _both(q, k, v, do, scale)
    f32 = [t.float() for t in (q, k, v, do)]
    exact = _both_plain_f32(*f32, scale)
    for name, g, p, x in zip(("o", "dq", "dk", "dv"), got, plain, exact):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        assert torch.isfinite(g).all(), name
        err_k = (g.float() - x).abs()
        err_p = (p.float() - x).abs()
        floor = 1e-5 * float(x.abs().max())
        assert float(err_k.max()) <= 2 * float(err_p.max()) + floor, (
            name, float(err_k.max()), float(err_p.max()))
        assert float(err_k.mean()) <= 2 * float(err_p.mean()) + floor, (
            name, float(err_k.mean()), float(err_p.mean()))


def _both_plain_f32(q, k, v, do, scale):
    o, m, l = flash.causal_attention_plain(q, k, v, scale)
    return (o, *flash.causal_attention_plain_backward(q, k, v, do, m, l,
                                                      scale))


@pytest.mark.card
@pytest.mark.parametrize("shape", ["qwen", "moonlight"])
def test_card_kernel_stats_match_plain(shape, card):
    """The forward's row statistics against the plain version's: m, a
    logit, within one bf16 rounding of it (2^-8 relative: the tensor
    cores' and cuBLAS's f32 sums of q·k may round to neighbouring bf16
    values), and l within 1e-3 relative (a sum of terms exp(s − m), each
    moved by at most that rounding's share)."""
    q, k, v, _ = _inputs(card, SHAPES[shape], seed=1)
    scale = attn._scale(q.shape[-1])
    _, m, l = flash._forward(q, k, v, scale)
    _, pm, pl = flash.causal_attention_plain(q, k, v, scale)
    torch.testing.assert_close(m, pm, rtol=2 ** -8, atol=0)
    torch.testing.assert_close(l, pl, rtol=1e-3, atol=0)


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
def test_card_kernel_bitwise_repeatable(shape, card):
    """Every sum runs in a fixed order, with no atomics: two runs of the
    forward and the backward are bitwise equal."""
    q, k, v, do = _inputs(card, SHAPES[shape], seed=2)
    scale = attn._scale(q.shape[-1])
    first = _both(q, k, v, do, scale)[0]
    second = _both(q, k, v, do, scale)[0]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.card
def test_card_launches_and_route(card):
    """The route through ``attention.causal_self_attention``: one launch a
    forward and two a backward at S = 4,096 in bf16, none at the encode's
    16 positions or in f32; the gradients reach q, k and v."""
    q, k, v, do = _inputs(card, SHAPES["qwen"], seed=3)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = flash.LAUNCHES
    out = attn.causal_self_attention(q, k, v)
    assert flash.LAUNCHES == before + 1
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert flash.LAUNCHES == before + 3
    assert all(g is not None and g.shape == t.shape
               for g, t in zip(grads, (q, k, v)))
    short = [t[:, :16].detach() for t in (q, k, v)]
    attn.causal_self_attention(*short)
    attn.causal_self_attention(*(t.float() for t in short))
    assert flash.LAUNCHES == before + 3
    # a second derivative stays on _sdpa: at the encode's shape, and at
    # any length inside second_order()
    s = [t.detach().requires_grad_() for t in short]
    (g,) = torch.autograd.grad(attn.causal_self_attention(*s).sum(), s[0],
                               create_graph=True)
    g.sum().backward()
    s = [t[:, :128].detach().requires_grad_() for t in (q, k, v)]
    with flash.second_order():
        out = attn.causal_self_attention(*s)
    (g,) = torch.autograd.grad(out.float().sum(), s[0], create_graph=True)
    g.float().sum().backward()
    assert flash.LAUNCHES == before + 3


@pytest.mark.card
def test_card_kernel_raises_on_what_it_does_not_take(card):
    q, k, v, _ = _inputs(card, SHAPES["grouped_ragged"])
    before = flash.LAUNCHES
    with pytest.raises(TypeError, match="bf16"):
        flash.causal_attention(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match="head dimensions"):
        flash.causal_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="strides"):
        flash.causal_attention(q[..., ::2], k[..., ::2], v[..., ::2], 0.125)
    assert flash.LAUNCHES == before


@pytest.mark.card
def test_card_bf16_encode_at_a_tile_of_positions(card):
    """A bf16 3SFC encode with 64 synthetic positions (a tile) through a
    two-layer model of 64-dim heads: its grad-of-grad runs inside
    ``second_order()`` and keeps ``_sdpa``; only the last, first-order
    evaluation takes B7 (per layer two forwards, the remat's included, and
    a backward of two launches)."""
    from repro_torch.configs.base import CompressorConfig, get_smoke_config
    from repro_torch.core import threesfc
    from repro_torch.core.tree import tree_map
    from repro_torch.models.build import (build_model, syn_loss_fn,
                                          syn_spec_for)
    cfg = get_smoke_config("qwen1.5-0.5b").replace(head_dim=64,
                                                   dtype="bfloat16")
    model = build_model(cfg)
    g = torch.Generator(device=card).manual_seed(0)
    params = model.init(g)
    spec = syn_spec_for(cfg, CompressorConfig(kind="threesfc", syn_seq=64,
                                              soft_label_rank=8))
    syn0 = threesfc.init_syn(g, spec)
    target = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                            device=card), params)
    before = flash.LAUNCHES
    res = threesfc.encode(syn_loss_fn(model), params, target, syn0, steps=2)
    assert flash.LAUNCHES == before + 4 * cfg.num_layers
    assert torch.isfinite(res.cosine) and torch.isfinite(res.s)
