"""Port parity for RoPE, the SwiGLU FFN and GQA attention
(``repro_torch.models.{rope,layers,attention}``) on the CPU, against the
JAX package's ``models/{rope,layers,attention}.py``.

Inputs are drawn from a seed with numpy and handed to both sides. The
tolerance is rtol/atol 1e-4, the block bound of tests/test_torch_lm.py:
the two sides differ in summation order only. Mirrors
tests/test_model_math.py's RoPE and window-mask cases (:17-46), and holds
``prefill_cache``'s ring layout at ``cache_len`` below, equal to and above
the prompt, and ``decode_attention``'s ring write, validity and window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo import given, settings, st

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.rope import apply_rope as japply_rope
from repro.models.rope import rope_freqs as jrope_freqs
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.rope import apply_rope, rope_freqs

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
D, H, KV, HD = 32, 4, 2, 8


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(bias: bool, seed: int = 0):
    """Reference attention params (biases drawn non-zero) on both sides."""
    p = jattn.attn_init(jax.random.PRNGKey(seed), D, H, KV, HD, bias)
    p = _np_tree(p)
    if bias:
        rng = np.random.default_rng(seed + 1)
        for k in ("bq", "bk", "bv"):
            p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p, params_from_numpy(p, CPU)


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# RoPE (tests/test_model_math.py:17-39)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (64, 1e6), (128, 5e5)])
def test_rope_freqs_match_reference(hd, theta):
    np.testing.assert_array_equal(rope_freqs(hd, theta).numpy(),
                                  np.asarray(jrope_freqs(hd, theta)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    """Halves rotated against each other in f32, cast back to the input's
    dtype; positions given explicitly (a decode step's single one too)."""
    x = _x((2, 8, 4, 16))
    pos = np.array([0, 1, 2, 5, 7, 11, 100, 4095])
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = apply_rope(tx, torch.from_numpy(pos), 10000.0)
    want = japply_rope(jx, jnp.asarray(pos), 10000.0)
    assert got.dtype == tx.dtype
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    one = apply_rope(tx[:, :1], torch.tensor([9]), 10000.0)
    jone = japply_rope(jx[:, :1], jnp.asarray([9]), 10000.0)
    np.testing.assert_allclose(one.float().numpy(),
                               np.asarray(jone, np.float32), **tol)


def test_apply_rope_splits_halves_not_pairs():
    """The first half rotates against the second (x1 = x[..., :hd/2]), not
    the interleaved even/odd pairs."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0                        # x1[0] = 1, x2[0] = 0
    y = apply_rope(x, torch.tensor([1]), 1.0)
    # angle 1 on the first frequency: (cos 1, ·, sin 1, ·)
    np.testing.assert_allclose(y[0, 0, 0].numpy(),
                               [np.cos(1.0), 0.0, np.sin(1.0), 0.0],
                               rtol=1e-6, atol=1e-7)


def test_rope_preserves_norm():
    x = torch.from_numpy(_x((2, 8, 4, 16)))
    y = apply_rope(x, torch.arange(8), 10000.0)
    np.testing.assert_allclose(torch.linalg.norm(y, dim=-1).numpy(),
                               torch.linalg.norm(x, dim=-1).numpy(),
                               rtol=1e-5)


def test_rope_relative_property():
    """q_i · k_j after RoPE depends only on (i - j)."""
    q = torch.from_numpy(_x((1, 1, 1, 32), 1))
    k = torch.from_numpy(_x((1, 1, 1, 32), 2))

    def score(i, j):
        qi = apply_rope(q, torch.tensor([i]), 10000.0)
        kj = apply_rope(k, torch.tensor([j]), 10000.0)
        return float(torch.sum(qi * kj))

    assert abs(score(5, 3) - score(9, 7)) < 1e-4
    assert abs(score(10, 10) - score(0, 0)) < 1e-4
    assert abs(score(5, 3) - score(5, 4)) > 1e-6


# ---------------------------------------------------------------------------
# masks (tests/test_model_math.py:42-50)
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 24), st.integers(0, 8))
def test_causal_window_mask(s, w):
    m = attn.causal_mask(s, s, window=w).numpy()
    for i in range(s):
        for j in range(s):
            want = j <= i and (w == 0 or j > i - w)
            assert m[i, j] == want, (i, j, w)


@pytest.mark.parametrize("sq,sk,window,offset", [
    (5, 5, 0, 0), (4, 9, 3, 5), (7, 7, 2, 0), (1, 12, 4, 11)])
def test_causal_mask_matches_reference(sq, sk, window, offset):
    np.testing.assert_array_equal(
        attn.causal_mask(sq, sk, window, offset).numpy(),
        np.asarray(jattn.causal_mask(sq, sk, window, offset)))


# ---------------------------------------------------------------------------
# the FFN and the attention block
# ---------------------------------------------------------------------------


def test_ffn_matches_reference():
    jp = _np_tree(jlayers.ffn_init(jax.random.PRNGKey(0), D, 48))
    x = _x((2, 5, D))
    _close(layers.ffn(params_from_numpy(jp, CPU), torch.from_numpy(x)),
           jlayers.ffn(jp, jnp.asarray(x)))


def test_ffn_and_attention_init_keep_the_reference_layout():
    jf = jlayers.ffn_init(jax.random.PRNGKey(0), D, 48)
    tf = layers.ffn_init(torch.Generator().manual_seed(0), D, 48)
    ja = jattn.attn_init(jax.random.PRNGKey(0), D, H, KV, HD, True)
    ta = attn.attn_init(torch.Generator().manual_seed(0), D, H, KV, HD, True)
    for t, j in ((tf, jf), (ta, ja)):
        assert sorted(t) == sorted(j)
        for k in j:
            assert tuple(t[k].shape) == j[k].shape
            assert t[k].dtype == torch.float32
    # biases start at zero, as the reference's
    assert not ta["bq"].any() and not ta["bk"].any() and not ta["bv"].any()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("window", [0, 3])
def test_self_attention_matches_reference(bias, window):
    jp, tp = _params(bias)
    x = _x((2, 9, D))
    got = attn.attention(tp, torch.from_numpy(x), theta=10000.0,
                         window=window)
    want = jattn.attention(jp, jnp.asarray(x), theta=10000.0, window=window)
    _close(got, want)


def test_cross_and_bidirectional_attention_match_reference():
    """Cross-attention (no RoPE on either side) and the encoder's
    non-causal self-attention."""
    jp, tp = _params(True)
    x, mem = _x((2, 5, D), 4), _x((2, 7, D), 5)
    got = attn.attention(tp, torch.from_numpy(x), theta=10000.0,
                         xkv=torch.from_numpy(mem), causal=False)
    want = jattn.attention(jp, jnp.asarray(x), theta=10000.0,
                           xkv=jnp.asarray(mem), causal=False)
    _close(got, want)
    got = attn.attention(tp, torch.from_numpy(mem), theta=10000.0,
                         causal=False)
    want = jattn.attention(jp, jnp.asarray(mem), theta=10000.0, causal=False)
    _close(got, want)


def test_sdpa_groups_heads_contiguously():
    """Query head h reads KV head h // G: with KV head 1's values zero,
    query heads 2 and 3 (G = 2) see zeros and heads 0 and 1 do not."""
    q = torch.from_numpy(_x((1, 3, H, HD), 6))
    k = torch.from_numpy(_x((1, 3, KV, HD), 7))
    v = torch.from_numpy(_x((1, 3, KV, HD), 8))
    v[:, :, 1] = 0.0
    out = attn._sdpa(q, k, v, None)
    assert out.shape == (1, 3, H, HD)
    assert not out[:, :, 2:].any() and out[:, :, :2].abs().min() >= 0
    assert out[:, :, :2].abs().sum() > 0
    want = jattn._sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                       jnp.asarray(v.numpy()), None)
    _close(out, want)


def test_sdpa_masks_with_a_finite_neg_inf():
    """A fully masked row stays finite (NEG_INF = -1e30, not -inf): the
    softmax of equal logits is uniform, as the reference computes it."""
    q = torch.from_numpy(_x((1, 2, H, HD), 9))
    k = torch.from_numpy(_x((1, 4, KV, HD), 10))
    v = torch.from_numpy(_x((1, 4, KV, HD), 11))
    mask = torch.zeros(2, 4, dtype=torch.bool)
    mask[1, :2] = True
    out = attn._sdpa(q, k, v, mask)
    assert attn.NEG_INF == jattn.NEG_INF == -1e30
    assert bool(torch.isfinite(out).all())
    want = jattn._sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                       jnp.asarray(v.numpy()), jnp.asarray(mask.numpy()))
    _close(out, want)


def test_sdpa_softmax_runs_in_f32_for_bf16_inputs():
    """bf16 q/k/v: logits in bf16, then cast to f32 and scaled, the
    softmax in f32, probabilities cast to v's dtype; within one bf16 ulp
    of the reference's."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 6, H, HD), (2, 6, KV, HD), (2, 6, KV, HD)))
    mask = attn.causal_mask(6, 6)
    got = attn._sdpa(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                     mask)
    want = jattn._sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                       jnp.asarray(mask.numpy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------------------
# the ring-buffer KV cache
# ---------------------------------------------------------------------------


def test_init_cache_matches_reference():
    got = attn.init_cache(2, 5, KV, HD, torch.float32)
    want = jattn.init_cache(2, 5, KV, HD, jnp.float32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype


@pytest.mark.parametrize("cache_len", [4, 7, 9, 12])
@pytest.mark.parametrize("window", [0, 3])
def test_prefill_cache_ring_layout_matches_reference(cache_len, window):
    """S = 9: ``cache_len`` below (the trailing keys kept in ring slots
    pos % cache_len; with no window the prefill attention windowed to
    cache_len), equal to and above S (zero padding, empty slots at
    position -1)."""
    jp, tp = _params(True)
    x = _x((2, 9, D))
    y, cache = attn.prefill_cache(tp, torch.from_numpy(x), cache_len,
                                  theta=10000.0, window=window)
    jy, jcache = jattn.prefill_cache(jp, jnp.asarray(x), cache_len,
                                     theta=10000.0, window=window)
    _close(y, jy)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
    assert cache.pos.dtype == torch.int32
    if cache_len < 9:
        # every kept position sits in its ring slot
        pos = cache.pos[0].numpy()
        np.testing.assert_array_equal(pos % cache_len, np.arange(cache_len))
    else:
        assert (cache.pos[:, 9:] == -1).all()


@pytest.mark.parametrize("cache_len,window,steps", [
    (12, 0, 3), (6, 0, 4), (4, 3, 5), (12, 3, 3)])
def test_decode_attention_matches_reference(cache_len, window, steps):
    """Decode steps after a 7-token prefill: the new token written at slot
    t % cache_len, validity (0 <= pos <= t) and the window, RoPE at the
    absolute position t; the input cache is not written."""
    jp, tp = _params(True)
    x = _x((2, 7, D))
    _, cache = attn.prefill_cache(tp, torch.from_numpy(x), cache_len,
                                  theta=10000.0, window=window)
    _, jcache = jattn.prefill_cache(jp, jnp.asarray(x), cache_len,
                                    theta=10000.0, window=window)
    for i in range(steps):
        xt = _x((2, D), 20 + i)
        before = [t.clone() for t in cache]
        y, new = attn.decode_attention(tp, torch.from_numpy(xt), cache, 7 + i,
                                       theta=10000.0, window=window)
        jy, jcache = jattn.decode_attention(jp, jnp.asarray(xt), jcache,
                                            7 + i, theta=10000.0,
                                            window=window)
        assert all(torch.equal(a, b) for a, b in zip(before, cache))
        _close(y, jy)
        _close(new.k, jcache.k)
        np.testing.assert_array_equal(new.pos.numpy(),
                                      np.asarray(jcache.pos))
        assert int(new.pos[0, (7 + i) % cache_len]) == 7 + i
        cache = new


def test_decode_attention_bf16_cache_keeps_its_dtype():
    """A bf16 cache (``init_cache``'s default) under f32 activations: the
    logits and the output projection promote to f32 as JAX's einsums do,
    the cache keeps bf16."""
    jp, tp = _params(False)
    cache = attn.init_cache(2, 4, KV, HD, torch.bfloat16)
    xt = _x((2, D))
    y, new = attn.decode_attention(tp, torch.from_numpy(xt), cache, 0,
                                   theta=10000.0)
    jy, jnew = jattn.decode_attention(
        jp, jnp.asarray(xt), jattn.init_cache(2, 4, KV, HD, jnp.bfloat16), 0,
        theta=10000.0)
    assert new.k.dtype == new.v.dtype == torch.bfloat16
    assert y.dtype == torch.float32 and new.pos.dtype == torch.int32
    assert new.pos[:, 0].tolist() == [0, 0] and (new.pos[:, 1:] == -1).all()
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(jnew.pos))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2 ** -7,
                               atol=2 ** -7)


# ---------------------------------------------------------------------------
# kernel B7's plain version and the causal route
# ---------------------------------------------------------------------------

# (D, DV) pairs the kernel is built for, as the plain version takes them
B7_PAIRS = [(64, 64), (192, 128)]
# S under, at and off a multiple of the forward's 64-query tile
B7_SEQS = [40, 64, 100]


def _b7_inputs(B, S, H, KV, D, DV, dtype, seed=0):
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(dtype).requires_grad_()
          for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, DV))]
    g = torch.from_numpy(rng.standard_normal((B, S, H, DV))
                         .astype(np.float32)).to(dtype)
    return ts, g


@pytest.mark.parametrize("S", B7_SEQS)
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("pair", B7_PAIRS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b7_plain_matches_sdpa_forward_and_gradients(dtype, pair, G, S):
    """The two-pass plain version (``kernels.causal_attention``, the path a
    CPU tensor takes) against ``_sdpa`` with ``causal_mask``, forward and
    the gradients of q, k and v through autograd: in f32 within 1e-5 (sum
    orders only); in bf16 within one bf16 ulp of the output's scale (l
    summed in another order moves a probability across a rounding
    boundary, no more)."""
    from repro_torch.kernels import causal_attention as flash
    D, DV = pair
    (q, k, v), g = _b7_inputs(2, S, 2 * G, 2, D, DV, dtype)
    want = attn._sdpa(q, k, v, attn.causal_mask(S, S))
    got = flash.causal_attention(q, k, v, attn._scale(D))
    assert got.dtype == dtype and got.shape == want.shape
    gw = torch.autograd.grad(want, (q, k, v), g)
    gg = torch.autograd.grad(got, (q, k, v), g)
    for a, b in zip((got, *gg), (want, *gw)):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = (1e-5 if dtype == torch.float32 else 2 ** -8) * float(
            b.detach().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol


@pytest.mark.parametrize("pair", B7_PAIRS)
def test_b7_plain_statistics_are_the_softmax_max_and_sum(pair):
    """The first pass's m and l are the rows' max and Σ exp(s − m) of the
    masked, scaled logits, (B, H, S) with H in ``_sdpa``'s head order."""
    from repro_torch.kernels import causal_attention as flash
    D, DV = pair
    (q, k, v), _ = _b7_inputs(1, 100, 4, 2, D, DV, torch.float32, seed=5)
    _, m, l = flash.causal_attention_plain(q, k, v, attn._scale(D))
    s = torch.einsum("bqhk,bshk->bhqs", q, k.repeat_interleave(2, dim=2))
    s = torch.where(attn.causal_mask(100, 100),
                    s * attn._scale(D), attn.NEG_INF)
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1),
                               rtol=1e-5, atol=0)


def test_b7_function_raises_under_create_graph():
    """Differentiable once: a backward with create_graph=True (a second
    derivative) raises rather than drop attention's second-order terms."""
    from repro_torch.kernels import causal_attention as flash
    (q, k, v), g = _b7_inputs(1, 70, 2, 2, 64, 64, torch.float32)
    out = flash.causal_attention(q, k, v, attn._scale(64))
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(out, q, g, create_graph=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b7_route_keeps_sdpa_on_the_cpu(dtype):
    """On the CPU ``causal_self_attention`` is ``_sdpa`` with
    ``causal_mask``, bitwise, at any length and dtype, its second
    derivative included (the 3SFC encoder's)."""
    (q, k, v), g = _b7_inputs(1, 80, 4, 2, 64, 64, dtype, seed=2)
    assert not attn.kernel_route(q, k, v)
    got = attn.causal_self_attention(q, k, v)
    want = attn._sdpa(q, k, v, attn.causal_mask(80, 80))
    assert torch.equal(got, want)
    (gq,) = torch.autograd.grad((got.float() * g.float()).sum(), q,
                                create_graph=True)
    (wq,) = torch.autograd.grad((want.float() * g.float()).sum(), q,
                                create_graph=True)
    assert torch.equal(gq, wq)
    (hg,) = torch.autograd.grad(gq.float().square().sum(), k)
    (hw,) = torch.autograd.grad(wq.float().square().sum(), k)
    assert torch.equal(hg, hw)


@pytest.mark.parametrize("case,takes", [
    ("bf16", True), ("f32", False), ("short", False), ("window", False),
    ("head_dims", False), ("cross", False), ("grouped", True),
    ("latent", True), ("second_order", False)])
def test_b7_route_by_what_it_observes(case, takes):
    """On fake CUDA tensors (no card needed): the kernel takes bf16 causal
    self-attention with instantiated head dims, no window and at least a
    tile of positions; f32, a short sequence (the encoder's 16 synthetic
    positions), a window, other head dims, unequal query and key lengths
    and a forward inside ``second_order()`` (a second derivative to come,
    at any length) keep ``_sdpa``. The kernel's route runs the meta branch
    (no launch counted)."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import causal_attention as flash
    S, H, KV, D, DV, dt, window, Sk = 128, 4, 4, 64, 64, torch.bfloat16, 0, 0
    if case == "f32":
        dt = torch.float32
    elif case == "short":
        S = 16
    elif case == "window":
        window = 32
    elif case == "head_dims":
        D = DV = 32
    elif case == "cross":
        Sk = 256
    elif case == "grouped":
        KV = 2
    elif case == "latent":
        D, DV = 192, 128
    scope = (flash.second_order() if case == "second_order"
             else contextlib.nullcontext())
    before = flash.LAUNCHES
    with FakeTensorMode(), scope:
        q = torch.empty((1, S, H, D), dtype=dt, device="cuda")
        k = torch.empty((1, Sk or S, KV, D), dtype=dt, device="cuda")
        v = torch.empty((1, Sk or S, KV, DV), dtype=dt, device="cuda")
        assert attn.kernel_route(q, k, v, window) == takes
        if takes:
            out = attn.causal_self_attention(q, k, v)
            assert out.shape == (1, S, H, DV) and out.dtype == dt
    assert flash.LAUNCHES == before


def test_attention_span_and_route_counters():
    """With tracing on, each ``attention`` call is one ``attention`` span;
    causal self-attention counts its route (here ``attention.plain``: the
    CPU), cross-attention none."""
    from repro_torch.obs import configure_tracer
    _, tp = _params(False)
    x = torch.from_numpy(_x((2, 5, D), 4))
    tracer = configure_tracer(True)
    try:
        attn.attention(tp, x, theta=10000.0)
        attn.attention(tp, x, theta=10000.0, xkv=x, causal=False)
        names = [r["name"] for r in tracer.drain()]
        counts = dict(tracer._counts)
    finally:
        configure_tracer(False)
    assert names.count("attention") == 2
    assert counts == {"attention.plain": 1}


@pytest.mark.parametrize("encoder", ["threesfc", "fedsynth"])
def test_encoders_run_their_second_derivative_in_second_order(encoder):
    """The forwards a second derivative runs through (3SFC's S steps,
    FedSynth's unrolled objective) run inside ``second_order()``, so
    attention keeps ``_sdpa`` there at any synthetic length; the
    first-order evaluations (3SFC's last, FedSynth's decode) run outside
    it, where B7 may take them."""
    from repro_torch.core import fedsynth, threesfc
    from repro_torch.kernels import causal_attention as flash
    rng = np.random.default_rng(0)
    w = {"a": torch.from_numpy(rng.standard_normal((6, 3))
                               .astype(np.float32))}
    target = {"a": torch.from_numpy(rng.standard_normal((6, 3))
                                    .astype(np.float32))}
    syn0 = threesfc.SynData(
        torch.from_numpy(rng.standard_normal((2, 6)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)),
        torch.zeros((0, 0)))
    seen = []

    def loss_fn(p, syn):
        seen.append(flash.in_second_order())
        return threesfc.soft_xent(syn.x @ p["a"], syn.labels())

    if encoder == "threesfc":
        threesfc.encode(loss_fn, w, target, syn0, steps=3)
        assert seen == [True, True, True, False]
    else:
        fedsynth.encode(loss_fn, w, target, syn0, unroll_steps=2,
                        opt_steps=2)
        assert seen == [True, True, True, True, False, False]
    assert not flash.in_second_order()


def test_bf16_encode_at_a_tile_of_positions_keeps_sdpa_for_its_grad_of_grad(
        monkeypatch):
    """A bf16 3SFC encode with 64 synthetic positions (a tile) through a
    two-layer model of 64-dim heads, its route taken as on the card (the
    device aside; the CPU's B7 is the plain version, differentiable once
    as the kernel): the S steps' grad-of-grad, the remat's recomputed
    forwards included, keeps ``_sdpa``; only the last, first-order
    evaluation takes B7 (per layer two forwards and a backward). Without
    ``second_order()`` the encode raises."""
    import contextlib
    from repro_torch.configs.base import CompressorConfig, get_smoke_config
    from repro_torch.core import threesfc
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import causal_attention as flash
    from repro_torch.models.build import (build_model, syn_loss_fn,
                                          syn_spec_for)
    calls = []
    forward, backward = flash._forward, flash._backward
    monkeypatch.setattr(attn, "kernel_route", lambda q, k, v, window=0: (
        not flash.in_second_order() and q.dtype == torch.bfloat16
        and (q.shape[-1], v.shape[-1]) in flash.PAIRS and window == 0
        and q.shape[-3] == k.shape[-3] >= flash.TILE))
    monkeypatch.setattr(flash, "_forward", lambda *a: (
        calls.append("fwd"), forward(*a))[1])
    monkeypatch.setattr(flash, "_backward", lambda *a: (
        calls.append("bwd"), backward(*a))[1])
    cfg = get_smoke_config("qwen1.5-0.5b").replace(head_dim=64,
                                                   dtype="bfloat16")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    syn0 = threesfc.init_syn(g, syn_spec_for(cfg, CompressorConfig(
        kind="threesfc", syn_seq=64, soft_label_rank=8)))
    target = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    res = threesfc.encode(syn_loss_fn(model), params, target, syn0, steps=2)
    assert sorted(calls) == ["bwd"] * cfg.num_layers + \
        ["fwd"] * (2 * cfg.num_layers)
    assert torch.isfinite(res.cosine) and torch.isfinite(res.s)
    monkeypatch.setattr(flash, "second_order", contextlib.nullcontext)
    with pytest.raises(RuntimeError, match="differentiable once"):
        threesfc.encode(syn_loss_fn(model), params, target, syn0, steps=2)


def test_second_order_scope_reaches_other_threads():
    """``second_order()`` holds process-wide: a CUDA backward, and the
    remat's forwards inside it, run on the autograd engine's own device
    thread, which must take the route the forward took."""
    import threading
    from repro_torch.kernels import causal_attention as flash
    seen = []

    def look():
        seen.append(flash.in_second_order())

    with flash.second_order():
        t = threading.Thread(target=look)
        t.start()
        t.join()
    look()
    assert seen == [True, False]
