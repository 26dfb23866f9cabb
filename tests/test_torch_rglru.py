"""Port parity for the RG-LRU recurrent block (``repro_torch.models.
rglru``) on the CPU, against the JAX package's ``models/rglru.py``.

Inputs are drawn from a seed with numpy; params come from the reference's
``rglru_init`` through ``params_from_numpy``. Tolerance rtol/atol 1e-4,
the block bound of tests/test_torch_lm.py: the doubling scan sums in
another order than XLA's ``associative_scan``. ``a_param``'s init is held
bitwise at recurrentgemma's smoke width; the GeLU is the tanh form (where
the exact one would miss the bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro_torch.convert import params_from_numpy
from repro_torch.models import rglru

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
D, W = 24, 16


def _params(seed=0, width=W):
    jp = jax.tree.map(np.asarray,
                      jrglru.rglru_init(jax.random.PRNGKey(seed), D, width))
    return jp, params_from_numpy(jp, CPU)


def _finite_a(jp):
    """The reference's a_param is +inf wherever expm1 overflows (see
    test_a_param_init_bitwise_the_reference); a finite spread of a in
    (0.5, 0.99) exercises the recurrence's decay on both sides."""
    jp = dict(jp)
    jp["a_param"] = np.linspace(0.0, 4.0, jp["a_param"].shape[0]).astype(
        np.float32)
    return jp, params_from_numpy(jp, CPU)


def _u(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 16, 128, 333, 4096])
def test_a_param_init_bitwise_the_reference(width):
    """``log(expm1(r / (1 - r)))``, r = linspace(0.9, 0.999)^(1/8), in f32
    as XLA evaluates it (the linspace's fused multiply-add included); 128
    is recurrentgemma's smoke width. It holds +inf wherever expm1
    overflows, as the reference's does."""
    want = np.asarray(jrglru.rglru_init(jax.random.PRNGKey(0), 4,
                                        width)["a_param"])
    got = rglru.a_param_init(width).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_a_param_init_at_the_published_width():
    """At recurrentgemma's 2,560 channels one entry of 2,560 differs in its
    last bits (XLA's own f32 pow rounds r = 0.98840382 up one ulp); both
    are ~85, where sigmoid is exactly 1 in f32, so a = 1 there on both
    sides and no number of the model moves."""
    want = np.asarray(jrglru.rglru_init(jax.random.PRNGKey(0), 4,
                                        2560)["a_param"])
    got = rglru.a_param_init(2560).numpy()
    diff = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
    assert diff.tolist() == [282]
    a = torch.sigmoid(torch.from_numpy(np.stack([got[diff], want[diff]])))
    assert (a == 1.0).all()
    assert np.isinf(got).sum() == np.isinf(want).sum() == 2191


def test_init_keeps_the_reference_layout():
    j = jrglru.rglru_init(jax.random.PRNGKey(0), D, W)
    t = rglru.rglru_init(torch.Generator().manual_seed(0), D, W)
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
    assert t["a_param"].dtype == torch.float32
    tb = rglru.rglru_init(torch.Generator().manual_seed(0), D, W,
                          dtype=torch.bfloat16)
    assert tb["a_param"].dtype == torch.float32
    assert tb["w_in"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the gates and the scan
# ---------------------------------------------------------------------------


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu``'s default is the tanh approximation; the exact form
    misses it by up to ~4.7e-4 at |x| ~ 2, over the block bound."""
    x = np.linspace(-4, 4, 801).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = rglru._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > TOL["atol"]


def test_lru_coeffs_match_reference():
    jp, tp = _finite_a(_params()[0])
    x = _u((2, 5, W))
    a, gx = rglru._lru_coeffs(tp, torch.from_numpy(x))
    ja, jgx = jrglru._lru_coeffs(jp, jnp.asarray(x))
    assert a.dtype == gx.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)


def test_lru_coeffs_clamp_the_input_term():
    """a = 1 (a_param = +inf, as the reference's init gives) keeps the
    input term at sqrt(1e-9), not 0."""
    _, tp = _params()
    x = torch.ones(1, 1, W)
    a, gx = rglru._lru_coeffs(tp, x)
    inf = torch.isinf(tp["a_param"])
    assert inf.any() and (a[..., inf] == 1.0).all()
    i = torch.sigmoid(x @ tp["w_gate_in"] + tp["b_gate_in"])
    np.testing.assert_allclose(gx[..., inf].numpy(),
                               (np.sqrt(np.float32(1e-9)) * i[..., inf]
                                ).numpy(), rtol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 3, 7, 8, 9, 64, 100])
def test_doubling_scan_is_the_recurrence(S):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, against the loop in f64."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32)
    b = rng.standard_normal((2, S, 3)).astype(np.float32)
    h = np.zeros((2, 3))
    want = []
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [5, 16, 33])
def test_doubling_scan_matches_the_associative_scan(S):
    rng = np.random.default_rng(40 + S)
    a = rng.uniform(0.0, 1.0, (2, S, 4)).astype(np.float32)
    b = rng.standard_normal((2, S, 4)).astype(np.float32)
    _, want = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[1] + r[0] * l[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("finite", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_forward_matches_reference(finite, with_h0):
    jp, tp = _params()
    if finite:
        jp, tp = _finite_a(jp)
    u = _u((2, 11, D))
    h0 = _u((2, W), 5) if with_h0 else None
    y, h = rglru.rglru_forward(tp, torch.from_numpy(u),
                               None if h0 is None else torch.from_numpy(h0))
    jy, jh = jrglru.rglru_forward(jp, jnp.asarray(u),
                                  None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert h.dtype == torch.float32


def test_rglru_forward_bf16_matches_reference():
    jp, tp = _finite_a(_params()[0])
    u = _u((2, 6, D))
    y, h = rglru.rglru_forward(tp, torch.from_numpy(u).bfloat16())
    jy, jh = jrglru.rglru_forward(jp, jnp.asarray(u, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=2 ** -6, atol=2 ** -6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2 ** -6,
                               atol=2 ** -6)


def test_decode_steps_match_reference_and_the_forward():
    """Token by token from a zero cache: each step equals the reference's
    step, and the last equals the full forward's last position."""
    jp, tp = _finite_a(_params()[0])
    u = _u((2, 6, D))
    cache = rglru.init_rglru_cache(2, W, 4, torch.float32)
    jcache = jrglru.init_rglru_cache(2, W, 4, jnp.float32)
    for t in range(6):
        y, cache = rglru.rglru_decode_step(tp, torch.from_numpy(u[:, t]),
                                           cache)
        jy, jcache = jrglru.rglru_decode_step(jp, jnp.asarray(u[:, t]),
                                              jcache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(cache.h.numpy(), np.asarray(jcache.h),
                                   **TOL)
        np.testing.assert_allclose(cache.conv_buf.numpy(),
                                   np.asarray(jcache.conv_buf), **TOL)
    full, hf = rglru.rglru_forward(tp, torch.from_numpy(u))
    np.testing.assert_allclose(y.numpy(), full[:, -1].numpy(), **TOL)
    np.testing.assert_allclose(cache.h.numpy(), hf.numpy(), **TOL)


def test_init_cache_matches_reference():
    got = rglru.init_rglru_cache(3, W, 4)
    want = jrglru.init_rglru_cache(3, W, 4)
    assert got.conv_buf.dtype == torch.bfloat16 and got.h.dtype == \
        torch.float32
    assert tuple(got.conv_buf.shape) == want.conv_buf.shape
    assert tuple(got.h.shape) == want.h.shape
    assert not got.conv_buf.any() and not got.h.any()
