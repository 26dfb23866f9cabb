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
