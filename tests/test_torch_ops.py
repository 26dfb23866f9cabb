"""Port parity for the kernel front end (``repro_torch.kernels.ops``) and the
tree algebra (``repro_torch.core.flat``), on the CPU, where each kernel
wrapper runs its plain PyTorch version.

Mirrors tests/test_tree_stats.py: the same numpy inputs go through
``repro.kernels.ops`` (Pallas in interpret mode, as its own tests run it)
and through the port. Tolerance rtol 2e-4, as the reference's own test
uses: the two sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jflat
from repro.kernels import ops as jops
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.kernels import ef_update as ef_mod
from repro_torch.kernels import fused_cosine as fc_mod
from repro_torch.kernels import ops

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL = 2e-4
# ragged on purpose: scalar leaf, sub-lane leaf, exact tile, tile+1, odd big
RAGGED_SHAPES = [(), (7,), (1024,), (1025,), (3, 341), (128, 1024), (13, 77, 5)]


def _pair(seed, shapes):
    rng = np.random.default_rng(seed)
    a = {f"p{i}": rng.standard_normal(s).astype(np.float32)
         for i, s in enumerate(shapes)}
    b = {f"p{i}": rng.standard_normal(s).astype(np.float32)
         for i, s in enumerate(shapes)}
    return a, b


def _both(a, b):
    """The numpy pair as JAX trees and as the port's trees."""
    ja = jax.tree.map(jnp.asarray, a)
    jb = jax.tree.map(jnp.asarray, b)
    return ja, jb, params_from_numpy(a, CPU), params_from_numpy(b, CPU)


def _assert_trees_close(got, want, **tol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                 to_numpy(got), jax.tree.map(np.asarray, want))


def test_ragged_tree_matches_reference():
    ja, jb, ta, tb = _both(*_pair(0, RAGGED_SHAPES))
    np.testing.assert_allclose(ops.tree_fused_stats(ta, tb).numpy(),
                               np.asarray(jops.tree_fused_stats(ja, jb)),
                               rtol=RTOL)


def test_matches_naive_tree_dot():
    _, _, ta, tb = _both(*_pair(1, RAGGED_SHAPES))
    st = flat.tree_stats(ta, tb)
    np.testing.assert_allclose(st[0], flat.tree_dot(ta, tb), rtol=1e-5)
    np.testing.assert_allclose(st[1], flat.tree_sqnorm(ta), rtol=RTOL)
    np.testing.assert_allclose(st[2], flat.tree_sqnorm(tb), rtol=RTOL)
    np.testing.assert_allclose(st, flat._tree_stats_naive(ta, tb), rtol=RTOL)


def test_single_scalar_leaf():
    st = ops.tree_fused_stats({"w": torch.tensor(3.0)},
                              {"w": torch.tensor(-2.0)})
    np.testing.assert_allclose(st.numpy(), [-6.0, 9.0, 4.0], rtol=1e-6)


def test_empty_tree_and_empty_leaf():
    np.testing.assert_array_equal(ops.tree_fused_stats({}, {}).numpy(),
                                  np.zeros(3))
    a = {"e": np.zeros((0,), np.float32), "x": np.ones((5,), np.float32)}
    b = {"e": np.zeros((0,), np.float32), "x": 2 * np.ones((5,), np.float32)}
    ja, jb, ta, tb = _both(a, b)
    got = ops.tree_fused_stats(ta, tb).numpy()
    np.testing.assert_allclose(got, [10.0, 5.0, 20.0], rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jops.tree_fused_stats(ja, jb)),
                               rtol=1e-6)


def test_bf16_leaves_cast_to_f32():
    a, b = _pair(2, RAGGED_SHAPES)
    ja, jb, ta, tb = _both(a, b)
    ta = {k: v.to(torch.bfloat16) for k, v in ta.items()}
    tb = {k: v.to(torch.bfloat16) for k, v in tb.items()}
    ja = {k: v.astype(jnp.bfloat16) for k, v in ja.items()}
    jb = {k: v.astype(jnp.bfloat16) for k, v in jb.items()}
    got = ops.tree_fused_stats(ta, tb)
    assert got.dtype == torch.float32
    # bf16 inputs are bitwise the same on both sides; only the f32 sum order
    # differs
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.tree_fused_stats(ja, jb)),
                               rtol=RTOL)


@pytest.mark.parametrize("shapes,chunk", [
    ([(5000,), (17,), (3000,)], 2048),
    ([(3,), (4,), (2047,), (1,)], 1024),
])
def test_chunking_crosses_leaf_boundaries(monkeypatch, shapes, chunk):
    """Force several kernel chunks on both sides with a small budget."""
    monkeypatch.setattr(jops, "TREE_CHUNK_ELEMS", chunk)
    monkeypatch.setattr(ops, "TREE_CHUNK_ELEMS", chunk)
    assert len(ops._chunk_plan([int(np.prod(s)) for s in shapes], chunk)) > 1
    ja, jb, ta, tb = _both(*_pair(3, shapes))
    np.testing.assert_allclose(ops.tree_fused_stats(ta, tb).numpy(),
                               np.asarray(jops.tree_fused_stats(ja, jb)),
                               rtol=RTOL)
    s = np.float32(-1.25)
    _assert_trees_close(ops.tree_ef_update(ta, tb, float(s)),
                        jops.tree_ef_update(ja, jb, jnp.float32(s)),
                        rtol=1e-5, atol=1e-6)


def test_chunk_plan_matches_reference():
    sizes = [5000, 0, 17, 1, 3000, 4096]
    for chunk in (1, 7, 1024, 2048, 1 << 22):
        assert ops._chunk_plan(sizes, chunk) == jops._chunk_plan(sizes, chunk)


def test_mismatched_trees_raise():
    with pytest.raises(ValueError, match="lockstep"):
        ops.tree_fused_stats({"w": torch.ones(4)}, {"w": torch.ones(6)})
    with pytest.raises(ValueError, match="lockstep"):
        ops.tree_fused_stats({"w": torch.ones(4)}, {"v": torch.ones(4)})
    with pytest.raises(ValueError, match="lockstep"):
        ops.tree_ef_update({"w": torch.ones(2, 3)}, {"w": torch.ones(3, 2)},
                           1.0)


def test_tree_ef_update_matches_axpy():
    ja, jb, ta, tb = _both(*_pair(7, RAGGED_SHAPES))
    s = np.float32(0.37)
    got = ops.tree_ef_update(ta, tb, torch.tensor(s))
    _assert_trees_close(got, jops.tree_ef_update(ja, jb, jnp.float32(s)),
                        rtol=1e-5, atol=1e-6)
    _assert_trees_close(got, jax.tree.map(lambda u, d: u - s * d, ja, jb),
                        rtol=1e-5, atol=1e-6)


def test_grad_and_grad_of_grad():
    """The encoder differentiates cosine-of-stats twice (grad-of-grad): the
    port's autograd.Function must match JAX's custom JVP at both orders."""
    a, b = _pair(6, [(129,), (1025,)])
    ja, jb, _, tb = _both(a, b)

    def jcos(a):
        d, aa, bb = jflat.tree_stats(a, jb)
        return d / (jnp.sqrt(aa) * jnp.sqrt(bb) + 1e-12)

    def tcos(a):
        d, aa, bb = flat.tree_stats(a, tb)
        return d / (torch.sqrt(aa) * torch.sqrt(bb) + 1e-12)

    ta = {k: torch.tensor(v, requires_grad=True) for k, v in a.items()}
    keys = sorted(ta)
    g = torch.autograd.grad(tcos(ta), [ta[k] for k in keys],
                            create_graph=True)
    jg = jax.grad(jcos)(ja)
    for k, gk in zip(keys, g):
        np.testing.assert_allclose(gk.detach().numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6)

    gsq = sum(torch.sum(gk * gk) for gk in g)
    gg = torch.autograd.grad(gsq, [ta[k] for k in keys])
    jgg = jax.grad(lambda a: jflat.tree_sqnorm(jax.grad(jcos)(a)))(ja)
    for k, ggk in zip(keys, gg):
        np.testing.assert_allclose(ggk.numpy(), np.asarray(jgg[k]),
                                   rtol=1e-3, atol=1e-6)


def test_backward_skips_operands_without_grad():
    a, b = _pair(8, [(10,), (3, 4)])
    ta = {k: torch.tensor(v, requires_grad=True) for k, v in a.items()}
    tb = params_from_numpy(b, CPU)
    st = ops.tree_fused_stats(ta, tb)
    (ga,) = torch.autograd.grad(st[0] + st[1], [ta["p1"]])
    np.testing.assert_allclose(ga.numpy(), b["p1"] + 2 * a["p1"], rtol=1e-6)


def test_flat_vector_ops_match_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal(4097).astype(np.float32)
    y = (0.8 * x + 0.1 * rng.standard_normal(4097)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(ops.fused_cosine(tx, ty).numpy(),
                               np.asarray(jops.fused_cosine(jx, jy)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(ops.cosine_similarity(tx, ty)),
                               float(jops.cosine_similarity(jx, jy)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ops.optimal_scale(tx, ty)),
                               float(jops.optimal_scale(jx, jy)), rtol=1e-5)
    np.testing.assert_allclose(
        ops.ef_update(tx, ty, torch.tensor([0.5])).numpy(),
        np.asarray(jops.ef_update(jx, jy, jnp.float32(0.5))),
        rtol=1e-6, atol=1e-7)


def test_wrappers_check_their_inputs():
    x = torch.ones(8)
    with pytest.raises(TypeError):
        fc_mod.fused_cosine(x.double(), x.double())
    with pytest.raises(ValueError):
        fc_mod.fused_cosine(x, torch.ones(9))
    with pytest.raises(ValueError):
        fc_mod.fused_cosine(x.reshape(2, 4), x.reshape(2, 4))
    with pytest.raises(ValueError):
        fc_mod.fused_cosine(torch.ones(16)[::2], x)
    with pytest.raises(ValueError):
        ef_mod.ef_update(x, x, torch.ones(2))
    with pytest.raises(TypeError):
        ef_mod.ef_update(x, x, torch.ones(1, dtype=torch.float64))


def test_cpu_wrappers_run_the_plain_version_without_counting():
    """On CPU tensors the wrappers take the plain path and launch nothing."""
    fc0, ef0 = fc_mod.LAUNCHES, ef_mod.LAUNCHES
    x, y = torch.arange(5.0), torch.ones(5)
    np.testing.assert_allclose(fc_mod.fused_cosine(x, y).numpy(),
                               [10.0, 30.0, 5.0])
    np.testing.assert_allclose(ef_mod.ef_update(x, y, torch.tensor([2.0])),
                               x - 2.0)
    assert np.all(fc_mod.fused_cosine(x[:0], y[:0]).numpy() == 0)
    assert (fc_mod.LAUNCHES, ef_mod.LAUNCHES) == (fc0, ef0)


def test_flat_tree_algebra_matches_reference():
    a, b = _pair(10, [(3,), (2, 5), ()])
    ja, jb, ta, tb = _both(a, b)
    tol = dict(rtol=1e-6, atol=1e-7)
    _assert_trees_close(flat.tree_add(ta, tb), jflat.tree_add(ja, jb), **tol)
    _assert_trees_close(flat.tree_sub(ta, tb), jflat.tree_sub(ja, jb), **tol)
    _assert_trees_close(flat.tree_scale(ta, 0.3), jflat.tree_scale(ja, 0.3),
                        **tol)
    _assert_trees_close(flat.tree_axpy(-2.0, ta, tb),
                        jflat.tree_axpy(-2.0, ja, jb), **tol)
    for fn in ("tree_dot", "tree_cosine"):
        np.testing.assert_allclose(float(getattr(flat, fn)(ta, tb)),
                                   float(getattr(jflat, fn)(ja, jb)),
                                   rtol=1e-5)
    for fn in ("tree_sqnorm", "tree_norm"):
        np.testing.assert_allclose(float(getattr(flat, fn)(ta)),
                                   float(getattr(jflat, fn)(ja)), rtol=1e-5)
    assert flat.tree_size(ta) == jflat.tree_size(ja) == 14
    empty = {"e": np.zeros((0,), np.float32)}
    assert flat.tree_size(params_from_numpy(empty, CPU)) == \
        jflat.tree_size(jax.tree.map(jnp.asarray, empty))
    assert float(flat.tree_cosine({}, {})) == 0.0


def test_flattener_round_trip_matches_reference():
    a, _ = _pair(11, [(4,), (2, 3), ()])
    ja, _, ta, _ = _both(a, a)
    jf, tf = jflat.Flattener(ja), flat.Flattener(ta)
    assert tf.total == jf.total == 11
    assert tf.offsets == jf.offsets
    np.testing.assert_array_equal(tf.flatten(ta).numpy(),
                                  np.asarray(jf.flatten(ja)))
    _assert_trees_close(tf.unflatten(tf.flatten(ta)), ja, rtol=0, atol=0)
