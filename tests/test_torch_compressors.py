"""Port parity for the compressor library, on the CPU: the kernel front end
of B5 (``ops.sign_quant``) and B6 (``ops.topk_threshold`` +
``ops.topk_mask``), ``core.baselines``, ``core.error_feedback``, the
``randk`` strategy and the ``core.compressor`` facade.

* The front end against the JAX package's (``repro.kernels.ops``, its
  Pallas kernels in interpret mode, as its own tests run them) on the
  reference's size grid (tests/test_kernels.py) and on a vector of
  ±subnormals, ±0 and values exactly at τ: signs, masks and counts
  bitwise, the scale within rtol 1e-5 (a mean summed in another order),
  the sampled threshold bitwise (it is one of the data's values). One
  documented difference: at τ ≤ 1e-38 the reference's floor (itself
  subnormal, so 0 under its flush) lets the zeros of its tile padding pass,
  and its kernel counts them; the port has no padding and counts the n
  real elements, as ``repro.kernels.ref.topk_mask`` does.
* Every case of tests/test_compressors.py and tests/test_error_feedback.py
  on the port's functions, and parity with ``repro.core.baselines`` /
  ``error_feedback`` on the same vectors: top-k, STC and signSGD
  reconstructions within rtol 1e-6 (values are copied or scaled by a mean
  summed in another order), payload floats equal.
* rand-k: support and value invariants, and the reference's reconstruction
  bitwise given its index set (read off its support, fed through the
  index seam).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core import baselines as jbaselines
from repro.core import error_feedback as jef
from repro.core.strategy import make_strategy as jmake_strategy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.base import CompressorConfig
from repro_torch.core import baselines, flat
from repro_torch.core import error_feedback as ef
from repro_torch.core import strategy as S
from repro_torch.core.compressor import TreeCompressor, make_compressor
from repro_torch.core.strategy import leaf_k, make_strategy
from repro_torch.kernels import ops
from repro_torch.kernels import sign_quant as sq_mod
from repro_torch.kernels import topk_mask as tm_mod
from repro_torch.kernels.ftz import FLT_MIN

torch.set_num_threads(2)

# the reference's grids (tests/test_kernels.py)
SIZES = [1, 1000, 4096, 131072, 300001]
TOPK_GRID = [(n, f) for n in (1000, 131072, 300001)
             for f in (0.001, 0.01, 0.1)]
SCALE_RTOL = 1e-5
RECON_RTOL = 1e-6


def normal(seed: int, n: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(n)) \
        .astype(np.float32)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ±subnormals, ±0, the smallest normal and values that sit exactly at the
# thresholds of EDGE_TAUS
EDGE = np.array([1e-40, -1e-40, -3e-39, 0.5, -0.25, 0.0, -0.0, FLT_MIN,
                 -FLT_MIN, 1e-38, -1e-38, 0.25, -0.5, 2.0, 1e-39, 0.125],
                np.float32)
EDGE_TAUS = [0.0, 1e-39, 1e-38, FLT_MIN, 0.125, 0.25, 0.5]


# ---------------------------------------------------------------------------
# B5 front end: ops.sign_quant
# ---------------------------------------------------------------------------


def _check_sign_quant(x: np.ndarray) -> None:
    signs, scale = ops.sign_quant(torch.from_numpy(x))
    jsigns, jscale = jops.sign_quant(jnp.asarray(x))
    rsigns, rscale = jref.sign_quant(jnp.asarray(x))
    assert signs.dtype == torch.int8 and signs.shape == x.shape
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(rsigns))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=SCALE_RTOL)
    np.testing.assert_allclose(float(scale), float(rscale), rtol=SCALE_RTOL)


@pytest.mark.parametrize("n", SIZES)
def test_sign_quant_matches_reference(n):
    _check_sign_quant(normal(n, n))


def test_sign_quant_flushes_subnormals_as_the_reference():
    _check_sign_quant(EDGE)
    signs, _ = ops.sign_quant(torch.from_numpy(EDGE))
    # 1e-40, -1e-40, -3e-39 and 1e-38, 1e-39 are subnormal: sign 0
    assert signs[[0, 1, 2, 9, 10, 14]].tolist() == [0] * 6
    assert signs[[7, 8]].tolist() == [1, -1]


def test_sign_quant_shapes_dtypes_and_empty():
    x = torch.from_numpy(normal(3, 60).reshape(3, 4, 5))
    signs, scale = ops.sign_quant(x)
    assert signs.shape == (3, 4, 5)
    jsigns, jscale = jops.sign_quant(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=SCALE_RTOL)
    # bf16 leaves are cast to f32 first
    sb, _ = ops.sign_quant(x.to(torch.bfloat16))
    np.testing.assert_array_equal(sb.numpy(), signs.numpy())
    # n = 0: no signs and a NaN scale (0 / 0), as the reference's mean
    s0, sc0 = ops.sign_quant(torch.zeros(0))
    assert s0.shape == (0,) and bool(torch.isnan(sc0))
    with pytest.raises(TypeError, match="f32"):
        sq_mod.sign_quant(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(TypeError, match=r"\(n,\)"):
        sq_mod.sign_quant(torch.zeros((2, 2)))
    with pytest.raises(ValueError, match="contiguous"):
        sq_mod.sign_quant(torch.zeros(8)[::2])


# ---------------------------------------------------------------------------
# B6 front end: ops.topk_threshold + ops.topk_mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k_frac", TOPK_GRID)
def test_topk_mask_matches_reference(n, k_frac):
    x = normal(n, n)
    k = max(1, int(k_frac * n))
    jtau = jops.topk_threshold(jnp.asarray(x), k)
    tau = ops.topk_threshold(torch.from_numpy(x), k)
    assert tau.shape == () and bits(tau) == bits(jtau)
    got, cnt = ops.topk_mask(torch.from_numpy(x), tau)
    want, jcnt = jops.topk_mask(jnp.asarray(x), jtau)
    rwant, rcnt = jref.topk_mask(jnp.asarray(x), jtau)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(rwant))
    assert float(cnt) == float(jcnt) == float(rcnt)
    # the reference's band (tests/test_kernels.py)
    if n <= 65536:
        assert abs(int(cnt) - k) <= 1
    else:
        assert 0.3 * k <= int(cnt) <= 3 * k


@pytest.mark.parametrize("tau", EDGE_TAUS)
def test_topk_mask_tau_edges_match_reference(tau, record_property):
    x = jnp.asarray(EDGE)
    t = np.float32(tau)
    got, cnt = ops.topk_mask(torch.from_numpy(EDGE), torch.tensor(t))
    want, jcnt = jops.topk_mask(x, jnp.float32(t))
    rwant, rcnt = jref.topk_mask(x, jnp.float32(t))
    # a kept element keeps its own bits (subnormal or -0.0): the select does
    # not flush; a dropped one is +0.0
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(rwant))
    assert float(cnt) == float(rcnt)
    if tau <= 1e-38:
        # every element passes; the reference's kernel also counts its
        # tile padding (the Queue C fault), the port counts the n real ones
        assert float(cnt) == EDGE.size
        assert float(jcnt) > EDGE.size
        record_property("reference_padded_count", float(jcnt))
    else:
        assert float(cnt) == float(jcnt)


def test_topk_threshold_is_exact_below_the_sample():
    x = torch.from_numpy(normal(7, 5000))
    for k in (1, 17, 5000, 9000):
        tau = ops.topk_threshold(x, k)
        want = torch.sort(x.abs(), descending=True).values[min(k, 5000) - 1]
        assert float(tau) == float(want)
    # above the sample: every (n // sample)-th element, k scaled to it
    y = normal(8, 70001)
    assert bits(ops.topk_threshold(torch.from_numpy(y), 700, sample=1000)) \
        == bits(jops.topk_threshold(jnp.asarray(y), 700, sample=1000))


def test_topk_mask_shapes_and_checks():
    x = torch.from_numpy(normal(9, 24).reshape(2, 3, 4))
    out, cnt = ops.topk_mask(x, 0.5)
    assert out.shape == x.shape
    np.testing.assert_array_equal(
        out.numpy(), np.where(np.abs(x.numpy()) >= 0.5, x.numpy(), 0.0))
    assert float(cnt) == float((x.abs() >= 0.5).sum())
    out0, cnt0 = ops.topk_mask(torch.zeros(0), torch.tensor(1.0))
    assert out0.shape == (0,) and float(cnt0) == 0.0
    # a NaN threshold keeps nothing, as torch.maximum propagates it
    _, cnan = ops.topk_mask(x, torch.tensor(float("nan")))
    assert float(cnan) == 0.0
    with pytest.raises(TypeError, match="threshold"):
        tm_mod.topk_mask(torch.zeros(4), torch.zeros(2))
    tau = torch.tensor(0.1)
    with pytest.raises(TypeError, match="f32"):
        tm_mod.topk_mask(torch.zeros(4, dtype=torch.float64), tau)
    with pytest.raises(TypeError, match="threshold"):
        tm_mod.topk_mask(torch.zeros(4), tau.double())
    with pytest.raises(ValueError, match="contiguous"):
        tm_mod.topk_mask(torch.zeros(8)[::2], tau)


def test_cpu_front_end_runs_the_plain_versions_without_counting():
    x = torch.from_numpy(normal(10, 100))
    before = (sq_mod.LAUNCHES, tm_mod.LAUNCHES)
    s, sc = ops.sign_quant(x)
    ps, psc = sq_mod.sign_quant_plain(x)
    assert torch.equal(s, ps) and torch.equal(sc, psc)
    out, cnt = ops.topk_mask(x, torch.tensor(0.3))
    pout, pcnt = tm_mod.topk_mask_plain(x, torch.tensor(0.3))
    assert torch.equal(out, pout) and torch.equal(cnt, pcnt)
    assert (sq_mod.LAUNCHES, tm_mod.LAUNCHES) == before


# ---------------------------------------------------------------------------
# mirror of tests/test_compressors.py, plus parity with repro.core.baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 7), (2, 25), (3, 50),
                                    (4, 13)])
def test_topk_keeps_largest(seed, k):
    v = torch.from_numpy(normal(seed, 200))
    payload, recon = baselines.topk_compress(v, k)
    kept = np.nonzero(recon.numpy())[0]
    assert len(kept) <= k
    dropped = np.setdiff1d(np.arange(200), kept)
    if len(kept) and len(dropped):
        assert np.abs(v.numpy())[kept].min() >= \
            np.abs(v.numpy())[dropped].max() - 1e-6
    np.testing.assert_array_equal(recon.numpy()[kept], v.numpy()[kept])
    assert payload.floats == 2.0 * k
    jpayload, jrecon = jbaselines.topk_compress(jnp.asarray(v.numpy()), k)
    np.testing.assert_array_equal(recon.numpy(), np.asarray(jrecon))
    assert payload.floats == jpayload.floats


@pytest.mark.parametrize("seed", range(5))
def test_signsgd_recon(seed):
    v = torch.from_numpy(normal(seed, 333))
    payload, recon = baselines.signsgd_compress(v)
    scale = torch.mean(torch.abs(v))
    np.testing.assert_allclose(recon.numpy(), (scale * torch.sign(v)).numpy(),
                               rtol=1e-6)
    assert payload.floats == 333 / 32.0 + 1.0
    jpayload, jrecon = jbaselines.signsgd_compress(jnp.asarray(v.numpy()))
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon),
                               rtol=RECON_RTOL)
    np.testing.assert_array_equal(payload.data[0].numpy(),
                                  np.asarray(jpayload.data[0]))
    assert payload.floats == jpayload.floats


def test_stc_ternary():
    v = torch.from_numpy(normal(0, 500))
    payload, recon = baselines.stc_compress(v, 50)
    vals = recon.numpy()[np.nonzero(recon.numpy())[0]]
    assert len(np.unique(np.abs(vals))) == 1
    assert payload.floats == 50 + 50 / 32.0 + 1.0
    jpayload, jrecon = jbaselines.stc_compress(jnp.asarray(v.numpy()), 50)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon),
                               rtol=RECON_RTOL)
    np.testing.assert_array_equal(np.sort(payload.data[1].numpy()),
                                  np.sort(np.asarray(jpayload.data[1])))
    assert payload.floats == jpayload.floats


def test_subnormal_signs_match_reference():
    """signSGD and STC decide signs with subnormals flushed, and a zero
    keeps its sign, as ``jnp.sign`` under the reference's flush."""
    v = torch.from_numpy(EDGE)
    _, recon = baselines.signsgd_compress(v)
    _, jrecon = jbaselines.signsgd_compress(jnp.asarray(EDGE))
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon),
                               rtol=RECON_RTOL)
    zero = np.asarray(jrecon) == 0
    np.testing.assert_array_equal(bits(recon)[zero],
                                  bits(np.asarray(jrecon))[zero])
    # EDGE has tied magnitudes (none at the 11th): compare the kept signs
    # in index order; the kept -1e-38, 1e-38 and -3e-39 are subnormal
    payload, _ = baselines.stc_compress(v, 11)
    jpayload, _ = jbaselines.stc_compress(jnp.asarray(EDGE), 11)
    order = np.argsort(payload.data[1].numpy())
    jorder = np.argsort(np.asarray(jpayload.data[1]))
    np.testing.assert_array_equal(payload.data[1].numpy()[order],
                                  np.asarray(jpayload.data[1])[jorder])
    np.testing.assert_array_equal(bits(payload.data[0])[order],
                                  bits(np.asarray(jpayload.data[0]))[jorder])


def test_randk_unbiased_support():
    v = torch.arange(1.0, 101.0)
    _, recon = baselines.randk_compress(torch.Generator().manual_seed(1), v,
                                        10)
    nz = np.nonzero(recon.numpy())[0]
    assert len(nz) == 10
    np.testing.assert_array_equal(recon.numpy()[nz], v.numpy()[nz])


def test_randk_recon_bitwise_given_the_reference_draws():
    v = normal(11, 300) + np.float32(5.0)          # no exact zeros
    payload_j, jrecon = jbaselines.randk_compress(jax.random.PRNGKey(4),
                                                  jnp.asarray(v), 30)
    idx = torch.from_numpy(np.nonzero(np.asarray(jrecon))[0])
    assert idx.numel() == 30
    payload, recon = baselines.randk_compress(idx, torch.from_numpy(v), 30)
    np.testing.assert_array_equal(bits(recon), bits(np.asarray(jrecon)))
    assert payload.floats == payload_j.floats == 31.0


def test_randk_draws_distinct_indices_from_the_generator():
    v = torch.from_numpy(normal(12, 1000) + np.float32(5.0))
    a = baselines.randk_compress(torch.Generator().manual_seed(3), v, 100)
    b = baselines.randk_compress(torch.Generator().manual_seed(3), v, 100)
    c = baselines.randk_compress(torch.Generator().manual_seed(4), v, 100)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert len(set(a[0].data[1].tolist())) == 100
    # k is clamped to [1, n], as the reference's
    assert baselines.randk_compress(None, v[:5], 50)[0].floats == 6.0
    assert baselines.topk_compress(v[:5], 0)[0].floats == 2.0


def test_compression_rate_eq1():
    assert abs(baselines.compression_rate(795.0, 199210)
               - 795.0 / 199210) < 1e-12
    for d, budget in ((199210, 795.0), (10, 3.0), (100, 1.0)):
        assert baselines.keep_k_for_budget(d, budget) == \
            jbaselines.keep_k_for_budget(d, budget)
        assert baselines.compression_rate(budget, d) == \
            jbaselines.compression_rate(budget, d)
    assert baselines.compression_rate_bytes(3220, 199210) == \
        jbaselines.compression_rate_bytes(3220, 199210)
    assert baselines.identity_compress(torch.zeros(7))[0].floats == 7.0


def test_reconstruction_stats_match_reference():
    v = normal(13, 4096)
    r = v + normal(14, 4096, 1e-2)
    cos, err = baselines.reconstruction_stats(torch.from_numpy(v),
                                              torch.from_numpy(r))
    jcos, jerr = jbaselines.reconstruction_stats(jnp.asarray(v),
                                                 jnp.asarray(r))
    np.testing.assert_allclose(float(cos), float(jcos), rtol=1e-6)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-5)


# ---------------------------------------------------------------------------
# mirror of tests/test_error_feedback.py, plus parity with error_feedback
# ---------------------------------------------------------------------------


def _compress(kind):
    if kind == "topk":
        return lambda u: baselines.topk_compress(u, 7)
    if kind == "signsgd":
        return baselines.signsgd_compress
    return lambda u: baselines.stc_compress(u, 7)


def _jcompress(kind):
    if kind == "topk":
        return lambda u: jbaselines.topk_compress(u, 7)
    if kind == "signsgd":
        return jbaselines.signsgd_compress
    return lambda u: jbaselines.stc_compress(u, 7)


@pytest.mark.parametrize("kind", ["topk", "signsgd", "stc"])
@pytest.mark.parametrize("seed,rounds", [(0, 1), (1, 5), (2, 12)])
def test_ef_telescoping(seed, rounds, kind):
    d = 100
    e = ef.ef_init(d)
    total_g = torch.zeros(d)
    total_recon = torch.zeros(d)
    for t in range(rounds):
        g = torch.from_numpy(normal(1000 * seed + t, d))
        _, recon, e = ef.ef_step(_compress(kind), g, e)
        total_g += g
        total_recon += recon
    np.testing.assert_allclose((total_recon + e).numpy(), total_g.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["topk", "signsgd", "stc"])
def test_ef_step_matches_reference(kind):
    e, je = ef.ef_init(100), jef.ef_init(100)
    for t in range(4):
        g = normal(50 + t, 100)
        _, recon, e = ef.ef_step(_compress(kind), torch.from_numpy(g), e)
        _, jrecon, je = jef.ef_step(_jcompress(kind), jnp.asarray(g), je)
        np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon),
                                   rtol=RECON_RTOL, atol=1e-7)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-5,
                                   atol=1e-6)


def test_ef_disabled_keeps_residual_zeroed():
    e = ef.ef_init(50)
    g = torch.from_numpy(normal(0, 50))
    _, recon, e2 = ef.ef_step(lambda u: baselines.topk_compress(u, 5), g, e,
                              enabled=False)
    np.testing.assert_array_equal(e2.numpy(), np.zeros(50))
    assert int((recon != 0).sum()) == 5


def test_tree_ef_telescoping():
    params = {"w": torch.zeros((40, 5)), "b": torch.zeros((11,))}
    comp = make_compressor(CompressorConfig(kind="topk", keep_ratio=0.05))
    e = comp.init_state(params)
    tg = flat.tree_zeros_like(params)
    tr = flat.tree_zeros_like(params)
    for t in range(8):
        g = {k: torch.from_numpy(normal(100 * t + p.numel(), p.numel())
                                 .reshape(p.shape))
             for k, p in params.items()}
        recon, e, _ = comp.step(None, g, e, params)
        tg = flat.tree_add(tg, g)
        tr = flat.tree_add(tr, recon)
    resid = flat.tree_sub(tg, tr)
    for k in params:
        np.testing.assert_allclose(resid[k].numpy(), e[k].numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the randk strategy and the facade
# ---------------------------------------------------------------------------


def _tree(seed, shapes, shift=0.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) + shift).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (64, 8), "b": (100,), "c": (3, 7)}


def test_randk_strategy_matches_reference_given_its_draws():
    u = _tree(0, SHAPES, shift=4.0)                  # no exact zeros
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jcfg = JCompressorConfig(kind="randk", keep_ratio=0.1)
    jout = jmake_strategy(jcfg).client_encode(
        jax.random.PRNGKey(2), jax.tree.map(jnp.asarray, u),
        jax.tree.map(jnp.asarray, params))
    jleaves = [np.asarray(l) for l in jax.tree.leaves(jout.recon)]
    draws = tuple(torch.from_numpy(np.nonzero(l.reshape(-1))[0])
                  for l in jleaves)
    strat = make_strategy(CompressorConfig(kind="randk", keep_ratio=0.1))
    tu = {k: torch.from_numpy(v) for k, v in u.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    out = strat.client_encode(draws, tu, tparams)
    for g, w in zip(flat.tree_leaves(out.recon), jleaves):
        np.testing.assert_array_equal(bits(g), bits(w))
    assert strat.payload_floats(tparams) == \
        jmake_strategy(jcfg).payload_floats(jax.tree.map(jnp.asarray, params))
    assert float(out.floats) == float(jout.floats)
    # from a generator: leaf_k distinct kept coordinates per leaf, exact
    gen_out = strat.client_encode(torch.Generator().manual_seed(0), tu,
                                  tparams)
    for k, l in gen_out.recon.items():
        nz = torch.nonzero(l.reshape(-1)).reshape(-1)
        assert nz.numel() == leaf_k(l.numel(), 0.1)
        assert torch.equal(l.reshape(-1)[nz], tu[k].reshape(-1)[nz])


def test_tree_compressor_interface():
    params = {"a": torch.zeros((64, 8)), "b": torch.zeros((100,))}
    g = {k: torch.from_numpy(normal(0, p.numel()).reshape(p.shape))
         for k, p in params.items()}
    for kind in ("identity", "topk", "randk", "signsgd", "stc"):
        comp = make_compressor(CompressorConfig(kind=kind, keep_ratio=0.1))
        assert isinstance(comp, TreeCompressor) and comp.cfg.kind == kind
        e = comp.init_state(params)
        recon, e2, m = comp.step(torch.Generator().manual_seed(1), g, e,
                                 params)
        assert flat.tree_flatten(recon)[1] == flat.tree_flatten(params)[1]
        assert np.isfinite(float(m.cosine))
        assert comp.payload_floats(params) == float(m.payload_floats)
        assert comp.compress_tree == comp.strategy.client_encode
        if kind == "identity":
            np.testing.assert_allclose(float(m.cosine), 1.0, rtol=1e-6)
        # EF invariant of one step: recon + e' = g + e
        for k in params:
            np.testing.assert_allclose((recon[k] + e2[k]).numpy(),
                                       g[k].numpy(), rtol=1e-6, atol=1e-7)


def test_make_compressor_warns_exactly_once():
    ccfg = CompressorConfig(kind="topk", keep_ratio=0.2)
    S._DEPRECATION_SEEN.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        make_compressor(ccfg)
        make_compressor(ccfg)
    ws = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(ws) == 1 and "make_compressor" in str(ws[0].message), ws
    assert "make_strategy" in str(ws[0].message)


def test_tree_compressor_wire_step_delegates():
    params = {"a": torch.zeros((16, 4)), "b": torch.zeros((9,))}
    g = {k: torch.from_numpy(normal(5, p.numel()).reshape(p.shape))
         for k, p in params.items()}
    comp = make_compressor(CompressorConfig(kind="stc", keep_ratio=0.25))
    codec = comp.strategy.wire_codec(params)
    buf, e, m = comp.wire_step(None, g, comp.init_state(params), params,
                               codec=codec, round_idx=2, client_idx=1)
    want, e_want, _ = comp.strategy.wire_step(
        None, g, comp.init_state(params), params, codec=codec, round_idx=2,
        client_idx=1)
    assert torch.equal(buf, want) and buf.numel() == codec.nbytes
    for k in params:
        assert torch.equal(e[k], e_want[k])


@pytest.mark.parametrize("k", [1, 7, 500, 3333])
def test_topk_ties_match_reference(k):
    """On magnitudes with many ties, top-k and STC keep the reference's
    elements in its order: descending |v|, a tie to the lower index."""
    v = np.random.default_rng(k).integers(-20, 21, 10_000).astype(np.float32)
    for port, ref in ((baselines.topk_compress, jbaselines.topk_compress),
                      (baselines.stc_compress, jbaselines.stc_compress)):
        got, recon = port(torch.from_numpy(v), k)
        want, jrecon = ref(jnp.asarray(v), k)
        np.testing.assert_array_equal(got.data[1].numpy(),
                                      np.asarray(want.data[1]))
        # STC's mu is a mean summed in another order
        np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon),
                                   rtol=1e-6)
