"""Port parity for the MoE FFN (``repro_torch.models.moe``) on the CPU,
against the JAX package's ``models/moe.py``.

Routing decisions (the top-k experts, their order, the capacity drops and
the dispatch one-hots) are held bitwise; floats at rtol/atol 1e-4, the
block bound of tests/test_torch_lm.py. Mirrors tests/test_model_math.py's
three MoE cases (:107-140), and the tie order of ``lax.top_k`` (the lower
index first), which ``torch.topk`` does not promise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as moe_mod

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(E=4, k=2, d=16, ff=8, B=2, S=12, shared=0, seed=0):
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), d,
                                                 ff, E, shared))
    x = np.random.default_rng(seed + 1).standard_normal((B, S, d)).astype(
        np.float32)
    return jp, params_from_numpy(jp, CPU), x, k


def _dispatch_ref(jp, x, k, cf):
    """The reference's routing and its folded (B, S, E, C) dispatch, written
    out from moe_ffn's own steps (it returns neither)."""
    B, S, _ = x.shape
    E = jp["router"].shape[-1]
    C = max(1, int(cf * k * S / E))
    top_w, top_e, _ = jmoe._router(jp, jnp.asarray(x), k)
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.float32)
    flat = onehot.reshape(B, S * k, E)
    pos = (jnp.cumsum(flat, axis=1) - flat) * flat
    keep = pos < C
    cap = jax.nn.one_hot(pos.astype(jnp.int32), C, dtype=jnp.float32)
    disp = (flat * keep)[..., None] * cap
    comb = disp * top_w.reshape(B, S * k)[..., None, None]
    return (np.asarray(top_w), np.asarray(top_e), C,
            np.asarray(disp.reshape(B, S, k, E, C).sum(axis=2)),
            np.asarray(comb.reshape(B, S, k, E, C).sum(axis=2)))


# ---------------------------------------------------------------------------
# the router and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(4, 2), (8, 3), (16, 1)])
def test_router_matches_reference(E, k):
    jp, tp, x, _ = _setup(E=E, k=k)
    top_w, top_e, aux = moe_mod._router(tp, torch.from_numpy(x), k)
    jw, je, jaux = jmoe._router(jp, jnp.asarray(x), k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    np.testing.assert_allclose(top_w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index():
    """Equal probabilities: ``lax.top_k`` keeps the lower expert first."""
    x = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.0, 0.5, 0.5]])
    vals, idx = moe_mod.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 3]]


@pytest.mark.parametrize("cf", [0.1, 0.5, 1.25, 4.0])
@pytest.mark.parametrize("E,k,S", [(4, 2, 12), (8, 3, 7), (4, 1, 1)])
def test_dispatch_and_combine_bitwise_the_reference(cf, E, k, S):
    """The capacity in the reference's Python arithmetic, the queue places
    in (token, slot) order, the drops past C and the folded one-hots, bit
    for bit; combine's weights too (one nonzero per (e, c))."""
    jp, tp, x, _ = _setup(E=E, k=k, S=S)
    jw, je, C, jdisp, jcomb = _dispatch_ref(jp, x, k, cf)
    assert moe_mod.capacity(cf, k, S, E) == C
    disp, comb = moe_mod.dispatch_combine(
        torch.from_numpy(jw.copy()), torch.from_numpy(je.astype(np.int64)), E, C)
    np.testing.assert_array_equal(disp.numpy(), jdisp)
    np.testing.assert_array_equal(comb.numpy(), jcomb)


@pytest.mark.parametrize("cf,k,S,E", [(1.25, 8, 1024, 128), (1.25, 1, 1, 16),
                                      (0.1, 2, 3, 64), (2.0, 6, 1023, 64)])
def test_capacity_is_the_reference_formula(cf, k, S, E):
    assert moe_mod.capacity(cf, k, S, E) == max(1, int(cf * k * S / E))


# ---------------------------------------------------------------------------
# the FFN (tests/test_model_math.py:107-140)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [0, 1, 2])
@pytest.mark.parametrize("cf", [1.25, 0.3, 4.0])
def test_moe_ffn_matches_reference(shared, cf):
    jp, tp, x, k = _setup(shared=shared)
    out = moe_mod.moe_ffn(tp, torch.from_numpy(x), experts_per_token=k,
                          capacity_factor=cf)
    jout = jmoe.moe_ffn(jp, jnp.asarray(x), experts_per_token=k,
                        capacity_factor=cf)
    np.testing.assert_allclose(out.y.numpy(), np.asarray(jout.y), **TOL)
    np.testing.assert_allclose(float(out.aux_loss), float(jout.aux_loss),
                               rtol=1e-5)


def test_moe_ffn_bf16_activations_match_reference():
    jp, tp, x, k = _setup()
    out = moe_mod.moe_ffn(tp, torch.from_numpy(x).bfloat16(),
                          experts_per_token=k)
    jout = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16),
                        experts_per_token=k)
    assert out.y.dtype == torch.bfloat16
    np.testing.assert_allclose(out.y.float().numpy(),
                               np.asarray(jout.y, np.float32),
                               rtol=2 ** -6, atol=2 ** -6)


def test_moe_init_keeps_the_reference_layout():
    j = jmoe.moe_init(jax.random.PRNGKey(0), 16, 8, 4, 2)
    t = moe_mod.moe_init(torch.Generator().manual_seed(0), 16, 8, 4, 2)
    assert sorted(t) == sorted(j)
    for key in ("router", "w_in", "w_gate", "w_out"):
        assert tuple(t[key].shape) == j[key].shape
    assert sorted(t["shared"]) == sorted(j["shared"])
    assert tuple(t["shared"]["w_in"].shape) == (16, 16)
    # the router stays f32 whatever the params' dtype
    tb = moe_mod.moe_init(torch.Generator().manual_seed(0), 16, 8, 4,
                          dtype=torch.bfloat16)
    assert tb["router"].dtype == torch.float32
    assert tb["w_in"].dtype == torch.bfloat16


def test_moe_output_finite_and_aux_near_one():
    _, tp, x, k = _setup()
    out = moe_mod.moe_ffn(tp, torch.from_numpy(x), experts_per_token=k)
    assert out.y.shape == x.shape
    assert bool(torch.isfinite(out.y).all())
    # Switch aux loss ~= coef for near-uniform routing
    assert 0.0 < float(out.aux_loss) < 0.1


def test_moe_capacity_drops_tokens_not_crash():
    """At capacity_factor -> tiny, most tokens drop; output shrinks but
    stays finite (the block's residual carries dropped tokens)."""
    _, tp, x, k = _setup()
    full = moe_mod.moe_ffn(tp, torch.from_numpy(x), experts_per_token=k,
                           capacity_factor=8.0)
    tiny = moe_mod.moe_ffn(tp, torch.from_numpy(x), experts_per_token=k,
                           capacity_factor=0.1)
    assert bool(torch.isfinite(tiny.y).all())
    assert float(torch.linalg.norm(tiny.y)) < float(torch.linalg.norm(full.y))


def test_moe_respects_router():
    """With the router forced to one expert, the output is that expert's
    SwiGLU applied to x."""
    d, ff, E = 8, 16, 4
    tp = moe_mod.moe_init(torch.Generator().manual_seed(0), d, ff, E)
    tp["router"] = tp["router"] * 0 + torch.tensor([-100., -100., 100.,
                                                    -100.])
    x = 0.05 + 0.1 * torch.abs(torch.randn(
        (1, 2, d), generator=torch.Generator().manual_seed(1)))
    out = moe_mod.moe_ffn(tp, x, experts_per_token=1, capacity_factor=8.0)
    h = x @ tp["w_in"][2]
    g = x @ tp["w_gate"][2]
    want = (torch.nn.functional.silu(g) * h) @ tp["w_out"][2]
    np.testing.assert_allclose(out.y.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
