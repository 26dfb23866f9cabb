"""Port parity for the in-round fault model (``repro_torch.fl.faults`` and the
masked round of ``repro_torch.fl.round``), on the CPU.

Mirrors tests/test_faults.py on its tiny world (MLP on a 4x4x1, 3-class
spec, N=4, K=1, B=8): schedule determinism and exact rate edges, the masked
pipeline under the null schedule bitwise the unfaulted round over the
reference's 14 (kind, wire, fused) combinations, EF frozen for a skipped
client under every strategy, residual mass conserved on a dropped payload,
the staleness ring buffer, cadence invariance, and the wire-hardening cases
that need no faulty channel. Then 3 rounds under one injected schedule with
a skipped, a dropped and a late client, in both packages: params within
rtol 1e-4 / atol 1e-6 and EF within rtol 1e-4 / atol 1e-5 (the rounds'
declared tolerances: the two frameworks differ only in summation order),
arrivals and the weight in flight exact. The schedule crosses as numpy
masks, so parity never depends on JAX's streams.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo import given, settings, st

from repro.comm import make_codec as jmake_codec
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.run import RunConfig as JRunConfig
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.fl import faults as JF
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models.build import vision_syn_spec as jsyn_spec
from repro.models.cnn import VisionSpec as JVisionSpec
from repro.models.cnn import make_paper_model as jmodel
from repro_torch.comm import InProcessChannel, make_codec
from repro_torch.comm.frame import (BadMagicError, FrameError, FrameSpec,
                                    TruncatedFrameError, encode_header,
                                    parse_header)
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.core.threesfc import SynData
from repro_torch.data.partition import dirichlet_partition
from repro_torch.fl import faults as F
from repro_torch.fl.client import local_train
from repro_torch.fl.engine import RoundEngine, device_pools, vision_batcher
from repro_torch.fl.round import (build_fl_round, client_generator, fl_init,
                                  fold_in)
from repro_torch.launch import train
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import VisionSpec, make_paper_model

torch.set_num_threads(2)

CPU = torch.device("cpu")
N, K, B = 4, 1, 8
LR = 0.05
SPEC = VisionSpec("tiny", (4, 4, 1), 3)
JSPEC = JVisionSpec("tiny", (4, 4, 1), 3)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)
PARITY_ROUNDS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    """The reference's tiny MLP params and batches, and the port's copy."""
    jm = jmodel("mlp", JSPEC)
    params = jm.init(jax.random.PRNGKey(0))
    batches = {
        "x": jax.random.normal(jax.random.PRNGKey(1), (N, K, B, 4, 4, 1)),
        "y": jax.random.randint(jax.random.PRNGKey(2), (N, K, B), 0, 3),
    }
    return {"jmodel": jm, "jparams": params, "jbatches": batches,
            "model": make_paper_model("mlp", SPEC),
            "params": params_from_numpy(_np(params), CPU),
            "batches": params_from_numpy(_np(batches), CPU)}


def _ccfg(kind):
    return CompressorConfig(kind=kind, keep_ratio=0.2, syn_steps=2,
                            syn_lr=0.1, error_feedback=kind != "identity")


def _strategy(model, ccfg):
    from repro_torch.core.strategy import make_strategy
    spec = vision_syn_spec(SPEC, ccfg)
    return make_strategy(ccfg, loss_fn=model.syn_loss, syn_spec=spec,
                         local_lr=LR), spec


def _fl(ccfg):
    return FLConfig(num_clients=N, local_steps=K, local_lr=LR, local_batch=B,
                    compressor=ccfg)


def _same_bits(a, b, what=""):
    for la, lb in zip(flat.tree_leaves(a), flat.tree_leaves(b)):
        np.testing.assert_array_equal(la.numpy(), lb.numpy(),
                                      err_msg=f"{what} not bit-exact")


def _schedule(part, deliv, delay):
    delay = torch.as_tensor(np.asarray(delay, np.int32))
    return F.FaultSchedule(torch.as_tensor(np.asarray(part, bool)),
                           torch.as_tensor(np.asarray(deliv, bool)), delay,
                           F.staleness_weight(delay))


# ---------------------------------------------------------------------------
# schedule determinism
# ---------------------------------------------------------------------------


def test_fault_schedule_deterministic_and_exact_at_rate_edges():
    kw = dict(participation_rate=0.5, drop_rate=0.3, straggler_rate=0.4,
              staleness_max=3)
    a = F.fault_schedule(42, 7, 16, **kw)
    b = F.fault_schedule(42, 7, 16, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y), "same (seed, round) schedule"
    c = F.fault_schedule(42, 8, 16, **kw)
    assert any(not torch.equal(x, y) for x, y in zip(a, c)), \
        "round must vary the pattern"
    assert a.participate.dtype == torch.bool and a.delay.dtype == torch.int32
    assert int(a.delay.max()) <= 3 and int(a.delay.min()) >= 0
    np.testing.assert_array_equal(
        a.weight.numpy(),
        np.float32(1.0) / (np.float32(1.0) + a.delay.numpy().astype(
            np.float32)))
    # rate edges are exact masks, not approximate ones
    e = F.fault_schedule(42, 3, 64)
    assert bool(e.participate.all()) and bool(e.delivered.all())
    assert bool((e.delay == 0).all()) and bool((e.weight == 1.0).all())
    z = F.fault_schedule(42, 3, 64, participation_rate=1.0, drop_rate=0.0,
                         straggler_rate=0.0, staleness_max=2)
    assert bool(z.arrives_now.all()) and not bool(z.arrives_late.any())
    n = F.null_schedule(5)
    assert bool(n.arrives_now.all()) and bool((n.weight == 1.0).all())
    # the delay stream is its own: staleness never changes who participates
    s0 = F.fault_schedule(42, 7, 16, participation_rate=0.5, drop_rate=0.3)
    assert torch.equal(s0.participate, a.participate)
    assert torch.equal(s0.delivered, a.delivered)


def test_fault_schedule_rates_are_roughly_honored():
    hits = np.mean([F.fault_schedule(0, r, 64, participation_rate=0.5)
                    .participate.float().mean().item() for r in range(32)])
    assert 0.4 < hits < 0.6, hits
    late = np.mean([F.fault_schedule(0, r, 64, straggler_rate=0.25,
                                     staleness_max=2).arrives_late.float()
                    .mean().item() for r in range(32)])
    assert 0.15 < late < 0.35, late


# ---------------------------------------------------------------------------
# zero-fault bitwise: masked pipeline + null schedule == unfaulted pipeline
# ---------------------------------------------------------------------------

ALL_KINDS = ("identity", "topk", "randk", "signsgd", "stc", "threesfc",
             "fedsynth")
CODEC_KINDS = ("identity", "topk", "signsgd", "stc", "threesfc")

VMAP_COMBOS = (
    [(k, "float", False) for k in ALL_KINDS]
    + [(k, "codec", False) for k in CODEC_KINDS]
    + [("threesfc", "float", True), ("threesfc", "codec", True)]
)


@pytest.mark.parametrize("kind,wire,fused", VMAP_COMBOS,
                         ids=[f"{k}-{w}{'-fused' if f else ''}"
                              for k, w, f in VMAP_COMBOS])
def test_zero_fault_schedule_bitwise(world, kind, wire, fused):
    model, params, batches = world["model"], world["params"], world["batches"]
    ccfg = _ccfg(kind)
    strat, spec = _strategy(model, ccfg)
    run = RunConfig(fl=_fl(ccfg), wire=wire, fused_decode=fused)
    codec = make_codec(ccfg, params, syn_spec=spec,
                       syn_loss_fn=model.syn_loss) if wire == "codec" else None
    rf = build_fl_round(model.loss, strat, run, codec=codec)
    rf_null = build_fl_round(model.loss, strat, run, codec=codec,
                             fault_schedule_fn=lambda r, n:
                             F.null_schedule(n))
    sa, sb = fl_init(params, N, strat), fl_init(params, N, strat)
    for r in range(2):
        sa, ma = rf(sa, batches, fold_in(5, r))
        sb, mb = rf_null(sb, batches, fold_in(5, r))
    _same_bits(sa.params, sb.params, f"{kind}/{wire} params")
    _same_bits(sa.ef, sb.ef, f"{kind}/{wire} ef")
    for f in ("loss", "cosine", "payload_floats", "update_norm"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ma, f)), np.asarray(getattr(mb, f)),
            err_msg=f"{kind}/{wire} metric {f}")
    assert float(mb.arrivals) == float(N)


# ---------------------------------------------------------------------------
# EF correctness under faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_ef_freezes_for_skipped_client_every_strategy(world, kind):
    """A client skipped for k rounds keeps its residual bit for bit."""
    model, params, batches = world["model"], world["params"], world["batches"]
    strat, _ = _strategy(model, _ccfg(kind))

    def sched(r, n):
        # round 0: everyone (a nonzero residual); then client 0 is skipped
        return _schedule([r < 1 or i != 0 for i in range(n)], [True] * n,
                         [0] * n)

    rf = build_fl_round(model.loss, strat, RunConfig(fl=_fl(_ccfg(kind))),
                        fault_schedule_fn=sched)
    st, _ = rf(fl_init(params, N, strat), batches, fold_in(9, 0))
    ef_after_r0 = flat.tree_map(lambda e: e[0].clone(), st.ef)
    if strat.cfg.error_feedback:
        assert any(float(l.abs().max()) > 0
                   for l in flat.tree_leaves(ef_after_r0)), \
            "round 0 should leave a nonzero residual to freeze"
    for r in (1, 2):
        st, m = rf(st, batches, fold_in(9, r))
        assert float(m.arrivals) == float(N - 1)
    _same_bits(flat.tree_map(lambda e: e[0], st.ef), ef_after_r0,
               f"{kind} frozen residual")


def test_dropped_payload_conserves_residual_mass(world):
    """delivered=0 with EF on: e' = u = g + e, delivered mass 0; a healthy
    client keeps e' + recon == u."""
    model, params, batches = world["model"], world["params"], world["batches"]
    strat, _ = _strategy(model, _ccfg("topk"))
    rf = build_fl_round(model.loss, strat, RunConfig(fl=_fl(_ccfg("topk"))),
                        fault_schedule_fn=lambda r, n: _schedule(
                            [True] * n, [i != 0 for i in range(n)], [0] * n))
    key = 11
    st, m = rf(fl_init(params, N, strat), batches, key)
    assert float(m.arrivals) == float(N - 1)
    zeros = flat.tree_zeros_like(params)
    for i, atol in ((0, 0.0), (1, 1e-6)):
        bi = flat.tree_map(lambda x: x[i], batches)
        g, _ = local_train(model.loss, params, bi, LR)
        recon, _, _ = strat.step(client_generator(key, i, CPU), g, zeros,
                                 params)
        e_new = flat.tree_map(lambda e: e[i], st.ef)
        delivered = zeros if i == 0 else recon
        assert F.residual_mass_conserved(g, e_new, delivered, atol=atol), \
            f"client {i}: residual mass not conserved"


def test_full_dropout_round_is_a_no_op_on_params(world):
    model, params, batches = world["model"], world["params"], world["batches"]
    strat, _ = _strategy(model, _ccfg("topk"))
    rf = build_fl_round(model.loss, strat, RunConfig(fl=_fl(_ccfg("topk"))),
                        fault_schedule_fn=lambda r, n: _schedule(
                            [True] * n, [False] * n, [0] * n))
    st, m = rf(fl_init(params, N, strat), batches, 1)
    _same_bits(st.params, params, "full-dropout params")
    assert float(m.arrivals) == 0.0 and float(m.update_norm) == 0.0


def test_fused_faults_need_mask_payloads(world):
    """Fused decode under faults is refused for a strategy without
    ``mask_payloads``, at build time, as in the reference."""
    from repro_torch.core.strategy import (CompressionStrategy,
                                           ThreeSFCStrategy)

    class NoMask(ThreeSFCStrategy):
        mask_payloads = CompressionStrategy.mask_payloads

    ccfg = _ccfg("threesfc")
    strat = NoMask(ccfg, loss_fn=world["model"].syn_loss,
                   syn_spec=vision_syn_spec(SPEC, ccfg))
    with pytest.raises(ValueError, match="mask_payloads"):
        build_fl_round(world["model"].loss, strat,
                       RunConfig(fl=_fl(ccfg), fused_decode=True,
                                 drop_rate=0.2))


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------


def test_consume_and_bank_unit():
    params = {"w": torch.zeros((3,))}
    buf, buf_w = F.init_stale_buffer(params, 2)
    recons = {"w": torch.stack([torch.full((3,), 2.0),
                                torch.full((3,), 4.0)])}
    delay = torch.tensor([2, 0], dtype=torch.int32)
    w_late = torch.tensor([0.5, 0.0])             # only client 0 banks
    # round 0: nothing mature yet; client 0 lands at slot 0 (consume, then
    # bank: delay == S reuses the just-freed slot)
    m, mw, buf, buf_w = F.consume_and_bank(buf, buf_w, 0, delay, w_late,
                                           recons)
    assert float(mw) == 0.0 and float(m["w"].abs().max()) == 0.0
    assert float(F.pending_mass(buf_w)) == 0.5
    zero_d, zero_w = torch.zeros(2, dtype=torch.int32), torch.zeros(2)
    m, mw, buf, buf_w = F.consume_and_bank(buf, buf_w, 1, zero_d, zero_w,
                                           recons)
    assert float(mw) == 0.0
    m, mw, buf, buf_w = F.consume_and_bank(buf, buf_w, 2, zero_d, zero_w,
                                           recons)
    assert float(mw) == 0.5
    np.testing.assert_allclose(m["w"].numpy(), 0.5 * 2.0 * np.ones(3))
    assert float(F.pending_mass(buf_w)) == 0.0
    assert F.init_stale_buffer(params, 0) == (None, None)
    assert float(F.pending_mass(None)) == 0.0


def test_consume_and_bank_matches_reference():
    """Element for element the reference's on the same numpy inputs, over
    rounds that wrap the ring, with several clients banked into one slot
    and weights that are zero."""
    rng = np.random.default_rng(3)
    S, n = 3, 5
    shapes = {"a": (4, 3), "b": (7,)}
    buf = {k: rng.standard_normal((S, *s)).astype(np.float32)
           for k, s in shapes.items()}
    buf_w = rng.random(S).astype(np.float32)
    jbuf, jw = jax.tree.map(jnp.asarray, buf), jnp.asarray(buf_w)
    tbuf, tw = params_from_numpy(buf, CPU), torch.from_numpy(buf_w.copy())
    for r in range(5):
        recons = {k: rng.standard_normal((n, *s)).astype(np.float32)
                  for k, s in shapes.items()}
        delay = rng.integers(0, S + 1, n).astype(np.int32)
        w_late = np.where(delay > 0, 1.0 / (1.0 + delay), 0.0).astype(
            np.float32)
        jout = JF.consume_and_bank(jbuf, jw, jnp.int32(r), jnp.asarray(delay),
                                   jnp.asarray(w_late),
                                   jax.tree.map(jnp.asarray, recons))
        tout = F.consume_and_bank(tbuf, tw, r, torch.from_numpy(delay),
                                  torch.from_numpy(w_late),
                                  params_from_numpy(recons, CPU))
        for got, want in zip(jax.tree.leaves(to_numpy(list(tout))),
                             jax.tree.leaves(_np(list(jout)))):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
        assert float(F.pending_mass(tout[3])) == float(
            JF.pending_mass(jout[3]))
        jbuf, jw, tbuf, tw = jout[2], jout[3], tout[2], tout[3]


def test_stale_payloads_arrive_next_round(world):
    """All clients straggle by exactly 1: round 0 applies nothing, round 1
    applies round 0's payloads (weight 1/2 each, renormalized)."""
    model, params, batches = world["model"], world["params"], world["batches"]
    strat, _ = _strategy(model, _ccfg("topk"))
    run = RunConfig(fl=_fl(_ccfg("topk")), staleness_max=1)
    rf = build_fl_round(model.loss, strat, run,
                        fault_schedule_fn=lambda r, n: _schedule(
                            [True] * n, [True] * n, [1] * n))
    st = fl_init(params, N, strat, staleness_max=1)
    st, m0 = rf(st, batches, fold_in(3, 0))
    _same_bits(st.params, params, "round-0 params (all payloads in flight)")
    assert float(m0.arrivals) == 0.0
    assert float(F.pending_mass(st.buf_w)) == pytest.approx(N * 0.5)
    st, m1 = rf(st, batches, fold_in(3, 1))
    assert float(m1.arrivals) == pytest.approx(N * 0.5)
    assert float(m1.update_norm) > 0.0
    assert any(not torch.equal(a, b) for a, b in zip(
        flat.tree_leaves(st.params), flat.tree_leaves(params)))


def test_staleness_requires_buffered_state(world):
    model, params, batches = world["model"], world["params"], world["batches"]
    strat, _ = _strategy(model, _ccfg("topk"))
    rf = build_fl_round(model.loss, strat,
                        RunConfig(fl=_fl(_ccfg("topk")), staleness_max=2,
                                  straggler_rate=0.5))
    with pytest.raises(ValueError, match="staleness buffer"):
        rf(fl_init(params, N, strat), batches, 0)


# ---------------------------------------------------------------------------
# engine integration: cadence invariance of the fault stream
# ---------------------------------------------------------------------------


def _engine(model, params, run, strat, x, y, parts):
    eng = RoundEngine(build_fl_round(model.loss, strat, run),
                      vision_batcher(x, y, device_pools(parts, CPU), K, B),
                      seed=0)
    return eng, eng.init_state(params, N, strategy=strat,
                               staleness_max=run.staleness_max)


@pytest.mark.parametrize("staleness", [0, 2])
def test_fault_cadence_invariance(world, staleness):
    """Same fault_seed: the same per-round pattern however rounds are
    grouped into blocks, blocks [4] and [2, 2] bitwise; another fault_seed
    gives another trajectory."""
    model, params = world["model"], world["params"]
    rng = np.random.default_rng(1)
    x = rng.random((200, 4, 4, 1), dtype=np.float32)
    y = rng.integers(0, 3, 200).astype(np.int32)
    parts = dirichlet_partition(y, N, alpha=0.5, seed=0, min_per_client=B)
    strat, _ = _strategy(model, _ccfg("topk"))
    run = RunConfig(fl=_fl(_ccfg("topk")), participation_rate=0.75,
                    drop_rate=0.3, fault_seed=13,
                    straggler_rate=0.5 if staleness else 0.0,
                    staleness_max=staleness)
    e1, s1 = _engine(model, params, run, strat, x, y, parts)
    s1, _ = e1.run_block(s1, 4)
    e2, s2 = _engine(model, params, run, strat, x, y, parts)
    s2, _ = e2.run_block(s2, 2)
    s2, _ = e2.run_block(s2, 2)
    _same_bits(s1.params, s2.params, "cadence params")
    _same_bits(s1.ef, s2.ef, "cadence ef")
    _same_bits(s1.buf, s2.buf, "cadence staleness buffer")
    assert s1.round == s2.round == 4
    e3, s3 = _engine(model, params, run.replace(fault_seed=14), strat, x, y,
                     parts)
    s3, _ = e3.run_block(s3, 4)
    assert any(not torch.equal(a, b) for a, b in zip(
        flat.tree_leaves(s1.params), flat.tree_leaves(s3.params)))


# ---------------------------------------------------------------------------
# parity with the reference under one injected schedule
# ---------------------------------------------------------------------------


def _jsched(staleness):
    """Client 0 skipped, client 1 dropped, client 2 late by 1 + r % 2
    (with staleness), client 3 healthy: the reference's schedule, and the
    port's from its numpy masks."""
    def jsched(r, n):
        i = jnp.arange(n)
        delay = jnp.where(i == 2, 1 + r % 2, 0) if staleness else \
            jnp.zeros((n,), jnp.int32)
        delay = delay.astype(jnp.int32)
        return JF.FaultSchedule(i != 0, i != 1, delay,
                                JF.staleness_weight(delay))

    def tsched(r, n):
        j = jsched(jnp.int32(r), n)
        return F.FaultSchedule(*[torch.from_numpy(np.array(t)) for t in j])

    return jsched, tsched


PARITY = [("threesfc", "float", False, 2), ("threesfc", "float", True, 0),
          ("topk", "codec", False, 2), ("signsgd", "codec", False, 2)]


@pytest.mark.parametrize("kind,wire,fused,staleness", PARITY,
                         ids=[f"{k}-{w}{'-fused' if f else ''}-S{s}"
                              for k, w, f, s in PARITY])
def test_faulted_rounds_match_reference(world, kind, wire, fused, staleness):
    jm, model = world["jmodel"], world["model"]
    jccfg = JCompressorConfig(kind=kind, keep_ratio=0.2, syn_steps=2,
                              syn_lr=0.1)
    jspec = jsyn_spec(JSPEC, jccfg)
    jstrat = jmake_strategy(jccfg, loss_fn=jm.syn_loss, syn_spec=jspec,
                            local_lr=LR)
    jrun = JRunConfig(fl=JFLConfig(num_clients=N, local_steps=K,
                                   local_lr=LR, local_batch=B,
                                   compressor=jccfg),
                      wire=wire, fused_decode=fused, staleness_max=staleness)
    jcodec = jmake_codec(jccfg, world["jparams"], syn_spec=jspec,
                         syn_loss_fn=jm.syn_loss) if wire == "codec" else None
    jsched, tsched = _jsched(staleness)
    jround = jax.jit(jbuild_round(jm.loss, jstrat, jrun, codec=jcodec,
                                  fault_schedule_fn=jsched))
    ccfg = _ccfg(kind)
    strat, spec = _strategy(model, ccfg)
    run = RunConfig(fl=_fl(ccfg), wire=wire, fused_decode=fused,
                    staleness_max=staleness)
    codec = make_codec(ccfg, world["params"], syn_spec=spec,
                       syn_loss_fn=model.syn_loss) if wire == "codec" else None
    tround = build_fl_round(model.loss, strat, run, codec=codec,
                            fault_schedule_fn=tsched)
    js = jfl_init(world["jparams"], N, jstrat, staleness_max=staleness)
    ts = fl_init(world["params"], N, strat, staleness_max=staleness)
    key = jax.random.PRNGKey(7)
    for r in range(PARITY_ROUNDS):
        key, kr = jax.random.split(key)
        syns = jax.vmap(lambda k: jthreesfc.init_syn(k, jspec))(
            jax.random.split(kr, N))
        js, jmet = jround(js, world["jbatches"], kr)
        ts, tmet = tround(ts, world["batches"], 0, syn0=SynData(
            *[torch.from_numpy(np.array(t)) for t in syns]))
        assert float(tmet.arrivals) == float(jmet.arrivals), r
        np.testing.assert_allclose(float(tmet.loss), float(jmet.loss),
                                   rtol=1e-5)
    assert ts.round == int(js.round) == PARITY_ROUNDS
    for got, want in zip(jax.tree.leaves(to_numpy(ts.params)),
                         jax.tree.leaves(_np(js.params))):
        np.testing.assert_allclose(got, want, **PARAM_TOL)
    for got, want in zip(jax.tree.leaves(to_numpy(ts.ef)),
                         jax.tree.leaves(_np(js.ef))):
        np.testing.assert_allclose(got, want, **EF_TOL)
    assert float(F.pending_mass(ts.buf_w)) == float(
        JF.pending_mass(js.buf_w))
    if staleness:
        assert float(F.pending_mass(ts.buf_w)) > 0.0
        for got, want in zip(jax.tree.leaves(to_numpy(ts.buf)),
                             jax.tree.leaves(_np(js.buf))):
            np.testing.assert_allclose(got, want, **EF_TOL)


def test_trainer_records_fault_knobs(tmp_path):
    out = tmp_path / "run"
    train.main(["--model", "mlp", "--dataset", "mnist", "--rounds", "2",
                "--clients", "3", "--local-steps", "1", "--batch", "8",
                "--train-size", "120", "--eval-every", "1", "--device", "cpu",
                "--participation-rate", "0.7", "--drop-rate", "0.2",
                "--straggler-rate", "0.3", "--staleness-max", "2",
                "--fault-seed", "5", "--out", str(out)])
    cfg = json.load(open(os.path.join(out, "run_config.json")))
    assert (cfg["participation_rate"], cfg["drop_rate"],
            cfg["straggler_rate"], cfg["staleness_max"],
            cfg["fault_seed"]) == (0.7, 0.2, 0.3, 2, 5)
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["round"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["cos"])
               for r in rows)


# ---------------------------------------------------------------------------
# wire hardening: byte accounting and typed header errors
# ---------------------------------------------------------------------------

_SPEC = FrameSpec("identity", "fp32", (8,))


def _valid_frame(round_idx=0, client_idx=0) -> np.ndarray:
    head = encode_header(_SPEC, round_idx, client_idx).numpy()
    return np.concatenate([head, np.arange(8, dtype=np.uint8)])


def test_linkstats_requires_open_round():
    ch = InProcessChannel()
    with pytest.raises(RuntimeError, match="begin_round"):
        ch.send_up(np.zeros((4,), np.uint8))
    ch.begin_round()
    ch.send_up(np.zeros((4,), np.uint8))
    assert ch.uplink.per_round == [4]
    ch.begin_round()
    ch.send_up(np.zeros((2,), np.uint8))
    assert ch.uplink.per_round == [4, 2]
    assert ch.uplink.total_bytes == 6 and ch.uplink.messages == 2


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=3),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_parse_header_fuzz_typed_errors(mode, seed):
    rng = np.random.default_rng(seed)
    base = _valid_frame(round_idx=3, client_idx=9)
    if mode == 0:       # truncation at a random point
        buf = base[: int(rng.integers(0, base.size))]
    elif mode == 1:     # random single-bit flips
        buf = base.copy()
        for _ in range(int(rng.integers(1, 6))):
            buf[int(rng.integers(0, buf.size))] ^= np.uint8(
                1 << int(rng.integers(0, 8)))
    elif mode == 2:     # pure garbage
        buf = rng.integers(0, 256, size=int(rng.integers(0, 64)),
                           dtype=np.uint8)
    else:               # valid frame, possibly extended with trailing junk
        buf = np.concatenate(
            [base, rng.integers(0, 256, size=int(rng.integers(0, 8)),
                                dtype=np.uint8)])
    try:
        hdr = parse_header(buf)
    except FrameError:
        return          # a typed rejection is always acceptable
    assert hdr["nbytes"] == buf.size
    assert hdr["payload_bytes"] == sum(hdr["section_bytes"])
    assert isinstance(hdr["kind"], str) and isinstance(hdr["policy"], str)


def test_parse_header_typed_error_subclasses():
    base = _valid_frame()
    with pytest.raises(TruncatedFrameError):
        parse_header(base[:8])
    bad = base.copy()
    bad[0] ^= 0xFF
    with pytest.raises(BadMagicError):
        parse_header(bad)
    assert issubclass(BadMagicError, FrameError)
    assert issubclass(FrameError, ValueError)
