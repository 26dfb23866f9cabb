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


# ---------------------------------------------------------------------------
# the dropless route (port-only: no JAX twin; held to a per-expert loop)
# ---------------------------------------------------------------------------


def _dropless_setup(E=8, n=4, lo=2, d=16, ff=8, shared=1, seed=0,
                    bias_std=0.1):
    gen = torch.Generator().manual_seed(seed)
    p = moe_mod.moe_init(gen, d, ff, E, shared, held=n, score_bias=True)
    p["score_bias"] = bias_std * torch.randn(E, generator=gen)
    x = torch.randn((2, 12, d), generator=gen)
    return p, x, lo


def _loop_ref(p, x, k, scaling, lo):
    """The held experts' part by a loop over experts on the tokens that
    chose each (boolean selection), summed per token in f32."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    bias = p["score_bias"]
    scores = torch.sigmoid(xt.float() @ p["router"].float()) + 0.0 * bias
    top = torch.sort(scores.detach() + bias, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    w = torch.gather(scores, -1, top)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scaling
    out = torch.zeros_like(xt, dtype=torch.float32)
    for j in range(p["w_in"].shape[0]):
        hit = top == lo + j
        rows = hit.any(-1)
        xe = xt[rows]
        ye = (torch.nn.functional.silu(xe @ p["w_gate"][j])
              * (xe @ p["w_in"][j])) @ p["w_out"][j]
        out = out.index_put((rows,), ye * (w * hit).sum(-1)[rows][:, None],
                            accumulate=True)
    return out.view(x.shape).to(x.dtype)


def _routed(p, x, lo, k=3, scaling=2.446):
    return moe_mod.routed_experts(p, x, experts_per_token=k, scaling=scaling,
                                  held_start=lo)


def _grads_of_every_order(fn, p, x):
    """(y, first-order grads of (x, leaves), grads of the grads' squared
    norm) of a scalar of ``fn``."""
    xs = x.clone().requires_grad_(True)
    ps = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) else v)
          for k, v in p.items() if k != "shared"}
    y = fn(ps, xs)
    loss = torch.sum(torch.sin(y))
    names = sorted(ps)
    leaves = [xs] + [ps[k] for k in names]
    g = torch.autograd.grad(loss, leaves, create_graph=True)
    gg = torch.autograd.grad(sum(torch.sum(t * t) for t in g), leaves,
                             allow_unused=True, materialize_grads=True)
    return y, g, gg


@pytest.mark.parametrize("E,n,lo,k", [(8, 4, 2, 3), (8, 8, 0, 2),
                                      (16, 2, 14, 6), (4, 1, 0, 1)])
def test_dropless_matches_the_per_expert_loop(E, n, lo, k):
    """Forward, gradient and grad-of-grad of the held experts' part, by
    ``x`` and every leaf, against the loop; the bias's gradient is zero
    (present, not missing)."""
    p, x, _ = _dropless_setup(E=E, n=n, lo=lo)
    y, g, gg = _grads_of_every_order(lambda q, t: _routed(q, t, lo, k), p, x)
    ry, rg, rgg = _grads_of_every_order(
        lambda q, t: _loop_ref(q, t, k, 2.446, lo), p, x)
    np.testing.assert_allclose(y.detach().numpy(), ry.detach().numpy(),
                               **TOL)
    for a, b in zip(g + gg, rg + rgg):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-4)
    names = sorted(k_ for k_ in p if k_ != "shared")
    bias_g = g[1 + names.index("score_bias")]
    assert bias_g is not None and not bias_g.any()


def test_the_bias_moves_the_choice_not_the_weights():
    """With the bias the choice changes on some tokens; the weights of the
    experts both choices share are the bare scores' (normalised over the
    chosen k), not the biased ones."""
    p, x, _ = _dropless_setup(E=8, n=8, lo=0, bias_std=0.0)
    xt = x.reshape(-1, x.shape[-1])
    w0, e0 = moe_mod.sigmoid_route(p, xt, 3, 1.0)
    p["score_bias"] = 0.3 * torch.randn(8, generator=torch.Generator()
                                        .manual_seed(5))
    w1, e1 = moe_mod.sigmoid_route(p, xt, 3, 1.0)
    assert (e0 != e1).any(dim=-1).any() and (e0 == e1).all(dim=-1).any()
    scores = torch.sigmoid(xt @ p["router"])
    for w, e in ((w0, e0), (w1, e1)):
        bare = torch.gather(scores, -1, e)
        np.testing.assert_allclose(w.numpy(),
                                   (bare / bare.sum(-1, keepdim=True))
                                   .numpy(), rtol=1e-6)
    biased = torch.sort(scores + p["score_bias"], dim=-1, descending=True,
                        stable=True).indices[:, :3]
    assert torch.equal(e1, biased)
    same = (e0 == e1).all(dim=-1)
    np.testing.assert_allclose(w1[same].numpy(), w0[same].numpy(),
                               rtol=1e-6)


def test_the_shares_of_the_experts_add_up_to_the_uncut_layer():
    """Expert parallelism: the 8 shares of 16 experts (2 held each), and
    the shared experts once, add up to the layer that holds all 16."""
    E, shards, k = 16, 8, 6
    full, x, _ = _dropless_setup(E=E, n=E, lo=0)
    n = E // shards
    total = moe_mod.moe_dropless(full, x, experts_per_token=k,
                                 scaling=2.446)
    parts = torch.zeros_like(x)
    for s in range(shards):
        share = dict(full, **{w: full[w][s * n:(s + 1) * n]
                              for w in ("w_in", "w_gate", "w_out")})
        parts = parts + moe_mod.routed_experts(share, x, experts_per_token=k,
                                               scaling=2.446,
                                               held_start=s * n)
    parts = parts + layers_ffn(full["shared"], x)
    np.testing.assert_allclose(parts.numpy(), total.numpy(), rtol=1e-5,
                               atol=1e-5)


def layers_ffn(p, x):
    from repro_torch.models import layers
    return layers.ffn(p, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_past_the_held_slots_get_no_gradient(dtype):
    """``torch._grouped_mm`` leaves the rows past its last offset unwritten
    and, in the double backward, gives them a nonzero gradient; the route
    cuts them: tokens with no held slot get exactly zero from the routed
    part, in the forward and in gradients of both orders, and so do the
    rows past the last offset of ``grouped_swiglu``."""
    p, x, lo = _dropless_setup(E=8, n=2, lo=3)
    p = {k: v.to(dtype) if k.startswith("w_") else v for k, v in p.items()}
    x = x.to(dtype)
    xt = x.reshape(-1, x.shape[-1])
    _, top = moe_mod.sigmoid_route(p, xt, 2, 1.0)
    none = ~((top >= lo) & (top < lo + 2)).any(-1)
    assert none.any() and (~none).any()
    y, g, gg = _grads_of_every_order(lambda q, t: _routed(q, t, lo, 2), p, x)
    assert not y.reshape(-1, x.shape[-1])[none].any()
    for t in (g[0], gg[0]):
        assert torch.isfinite(t).all()
        assert not t.reshape(-1, x.shape[-1])[none].any()
    # the grouped products alone: 5 of 9 rows held
    a = torch.randn(9, 16, dtype=dtype).requires_grad_(True)
    offs = torch.tensor([2, 5], dtype=torch.int32)
    out = moe_mod.grouped_swiglu(a, p, offs)
    ga, = torch.autograd.grad(torch.sum(torch.sin(out)), a,
                              create_graph=True)
    gga, = torch.autograd.grad(torch.sum(ga * ga), a)
    for t in (out, ga, gga):
        assert torch.isfinite(t).all() and not t[5:].any()
    assert out[:5].any() and gga[:5].any()


def test_held_layout_sorts_the_slots_by_held_expert():
    top = torch.tensor([[3, 0], [1, 3], [2, 4], [4, 1]])
    order, slot_row, offs, counts = moe_mod.held_layout(top, 1, 3)
    # slots (token, slot) flat: 3,0,1,3,2,4,4,1; held 1..3 as 0..2
    assert offs.dtype == torch.int32 and offs.tolist() == [2, 3, 5]
    assert counts.tolist() == [2, 1, 2]
    assert order.tolist() == [2, 7, 4, 0, 3, 1, 5, 6]
    assert torch.equal(order[slot_row], torch.arange(8))


def test_dropless_route_traces_without_host_reads(monkeypatch):
    """C6 for the dropless route: a train entry of the smoke Moonlight
    (bf16, the grouped products' dtype) traces on fake tensors, so no
    host read of a value and no shape from the data (``nonzero``, a
    boolean mask) is in it, as test_torch_dryrun.py::test_moe_entries_trace
    holds the capacity route."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as specs_lib
    from repro_torch.utils import hlo_analyzer as H
    monkeypatch.setattr(specs_lib, "INPUT_SHAPES", {
        "train_4k": ShapeConfig("train_4k", 64, 8, "train")})
    monkeypatch.setattr(specs_lib, "get_config", lambda a: get_smoke_config(
        a).replace(dtype="bfloat16"))
    with dryrun.fake_mesh((1, 1)) as mesh:
        entry, args = specs_lib.make_entry("moonlight-16b-a3b", "train_4k",
                                           mesh)
        with FakeTensorMode():
            fake = specs_lib.materialize(args, "cpu")
            tr = H.record(entry, *fake)
    assert H.analyze(tr).flops > 0
    ops = [o.op for o in tr.ops]
    assert any("grouped_mm" in o for o in ops)
    assert not any("nonzero" in o or "masked_select" in o for o in ops)
