"""The port's strategy and codec registries as a third-party extension
point: the mirror of the reference's ``tests/test_strategy_api.py`` rounds.

A toy compression method (per-leaf mean-magnitude × sign) and a trivial
lossless codec are registered on the port inside a fixture, and removed
after it, so that the tests which pin the registered kinds see only the
built-in ones. The toy method runs a full float-mode round, held to the
reference's round of the same method on the same params and batches, and
a codec-mode round, which decodes its frames through
``Codec.decode_batch``'s default path (frame by frame) and must be bitwise
the float-mode round; and on 2 gloo ranks the sharded codec round, which
must be bitwise the single-process float round (the reference's own
shard_map case fails on the reference, ROADMAP Queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.run import RunConfig as JRunConfig
from repro.core import strategy as JS
from repro.fl.round import build_fl_round as jbuild_fl_round
from repro.fl.round import fl_init as jfl_init
from repro.models.cnn import VisionSpec as JVisionSpec
from repro.models.cnn import make_paper_model as jmake_paper_model
from repro_torch.comm import Codec
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.core import strategy as S
from repro_torch.fl.round import build_fl_round, fl_init
from repro_torch.models.cnn import VisionSpec, make_paper_model

from _torch_fanout import assert_check, run_ranks
from _torch_toy import (TOY_KIND, ToyCodec, ToyMeanSign, register_toy,
                        unregister_toy)

torch.set_num_threads(2)

CPU = torch.device("cpu")
# the reference's toy, registered on the reference under a kind of its own
# (its tests register TOY_KIND there when they are imported)
J_TOY_KIND = "toy_meansign_port_parity"
N, K, B = 4, 2, 8
# the port's round against the reference's (tests/test_torch_round.py)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)


class JToyMeanSign(JS.CompressionStrategy):
    """The same method on the reference."""

    def payload_floats(self, params):
        leaves = jax.tree_util.tree_leaves(params)
        return sum(l.size for l in leaves) / 32.0 + len(leaves)

    def client_encode(self, key, u, params):
        recon = jax.tree_util.tree_map(
            lambda l: jnp.mean(jnp.abs(l)) * jnp.sign(l), u)
        return JS.TreeCompressed(
            recon, jnp.float32(self.payload_floats(params)), jnp.float32(0),
            wire=recon)

    def server_decode(self, payload, params):
        return payload


@pytest.fixture
def toy():
    """The toy method and codec registered on the port (and the method on
    the reference) for one test."""
    register_toy()
    JS.register_strategy(J_TOY_KIND)(JToyMeanSign)
    try:
        yield
    finally:
        unregister_toy()
        del JS.STRATEGIES[J_TOY_KIND]


def _world():
    """The reference test's world (a 4x4x1 -> 3 MLP, N=4 clients, K=2 steps
    of B=8), made with numpy for both frameworks."""
    spec = ("tiny", (4, 4, 1), 3)
    jmodel = jmake_paper_model("mlp", JVisionSpec(*spec))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = {"x": rng.standard_normal((N, K, B, 4, 4, 1)).astype(np.float32),
               "y": rng.integers(0, 3, (N, K, B)).astype(np.int32)}
    model = make_paper_model("mlp", VisionSpec(*spec))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    tbatches = {"x": torch.from_numpy(batches["x"]),
                "y": torch.from_numpy(batches["y"]).long()}
    return jmodel, jparams, batches, model, params, tbatches


def _cfg(kind):
    return dict(num_clients=N, local_steps=K, local_lr=0.05, local_batch=B,
                compressor=kind)


def _assert_close(got, want, tol):
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_toy_strategy_full_round_float(toy):
    jmodel, jparams, jbatches, model, params, batches = _world()
    strat = S.make_strategy(CompressorConfig(kind=TOY_KIND))
    assert isinstance(strat, ToyMeanSign) and TOY_KIND in S.strategy_kinds()
    rf = build_fl_round(model.loss, strat, RunConfig(
        fl=FLConfig(**_cfg(CompressorConfig(kind=TOY_KIND)))))
    state = fl_init(params, N, strat)
    s1, m = rf(state, batches, 3)
    assert np.isfinite(float(m.loss))
    assert float(m.payload_floats) == strat.payload_floats(params)
    assert float(m.wire_bytes_up) == 0.0
    # params actually moved and EF carries the residual u - recon
    assert any(not torch.equal(a, b) for a, b in zip(
        flat.tree_leaves(state.params), flat.tree_leaves(s1.params)))
    assert any(float(l.abs().max()) > 0 for l in flat.tree_leaves(s1.ef))
    # the reference's round of the same method on the same inputs
    jstrat = JS.make_strategy(JCompressorConfig(kind=J_TOY_KIND))
    jcfg = JFLConfig(**_cfg(JCompressorConfig(kind=J_TOY_KIND)))
    js1, jm = jax.jit(jbuild_fl_round(jmodel.loss, jstrat,
                                      JRunConfig(fl=jcfg)))(
        jfl_init(jparams, N, jstrat),
        jax.tree_util.tree_map(jnp.asarray, jbatches),
        jax.random.PRNGKey(3))
    _assert_close(s1.params, js1.params, PARAM_TOL)
    _assert_close(s1.ef, js1.ef, EF_TOL)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)


def test_toy_strategy_wire_codec_matches_float(toy):
    _, _, _, model, params, batches = _world()
    strat = S.make_strategy(CompressorConfig(kind=TOY_KIND))
    codec = strat.wire_codec(params)
    assert type(codec) is ToyCodec
    # no batch layout: the round decodes frame by frame
    assert type(codec).decode_batch is Codec.decode_batch
    assert type(codec).recon_batch is Codec.recon_batch
    fl = FLConfig(**_cfg(CompressorConfig(kind=TOY_KIND)))
    state = fl_init(params, N, strat)
    sf, mf = build_fl_round(model.loss, strat, RunConfig(fl=fl))(
        state, batches, 3)
    sw, mw = build_fl_round(model.loss, strat, RunConfig(fl=fl, wire="codec"),
                            codec=codec)(state, batches, 3)
    for a, b in zip(flat.tree_leaves((sf.params, sf.ef)),
                    flat.tree_leaves((sw.params, sw.ef))):
        assert torch.equal(a, b), "toy codec not transparent"
    for f in ("loss", "cosine", "payload_floats", "update_norm"):
        assert torch.equal(getattr(mf, f), getattr(mw, f))
    assert float(mw.wire_bytes_up) == codec.nbytes
    assert float(mf.wire_bytes_up) == 0.0


@pytest.mark.transport(timeout=300)
def test_toy_strategy_shard_map_codec(tmp_path):
    """The toy method (registered in each rank) over the sharded fan-out in
    wire mode on 2 ranks: bitwise the single-process float round, its
    codec being lossless."""
    assert_check(run_ranks("toy", 2, tmp_path, timeout=240),
                 "toy_strategy_shard_map_codec")


def test_duplicate_strategy_kind_rejected(toy):
    with pytest.raises(ValueError, match="already registered"):
        @S.register_strategy(TOY_KIND)
        class Dupe(S.CompressionStrategy):
            pass
    # the original registration is untouched
    assert S.STRATEGIES[TOY_KIND] is ToyMeanSign


def test_unknown_kind_lists_valid_names(toy):
    with pytest.raises(ValueError) as ei:
        S.make_strategy(CompressorConfig(kind="definitely_not_a_kind"))
    msg = str(ei.value)
    for known in ("threesfc", "topk", TOY_KIND):
        assert known in msg, msg


def test_strategy_kinds_introspection(toy):
    kinds = S.strategy_kinds()
    assert kinds == sorted(kinds)
    assert TOY_KIND in kinds and "threesfc" in kinds
