"""The sharded client fan-out (``client_parallel='shard_map'``) on the
CPU over gloo: the mirror of tests/test_shard_round.py.

The reference's own shard_map tests fail on this box's JAX (ROADMAP Queue
C), and its contract is shard_map ≡ vmap: bitwise for the width-stable
compressors, 3SFC width-matched bitwise and within 1e-5 on an 8-way mesh
(vmap's width changes XLA's batched-dot lowering). The port's round is a
loop over clients either way, so each client's math is the same under
both fan-outs and the contract is bitwise for every compressor: after 3
rounds the sharded round's params, gathered EF and every ``RoundMetrics``
field equal the single-process round's bit for bit, with exactly one
collective per round and the EF rows never gathered inside a round.

Each world (1, 2 and 4 ranks, and the reference's width-matched (1, 2)
mesh) is spawned once by ``_torch_fanout.run_ranks``; its checks are
``_torch_fanout.scenario_rounds``, each rank holding its own replica to
its own single-process oracle. One test holds the port's sharded round on
2 ranks to the JAX reference's vmap round, in the pytest process, within
the round tolerances of ``PERF.md`` §2 (the ranks never import JAX).
"""
import numpy as np
import pytest
import torch

from _torch_fanout import assert_check, run_ranks

torch.set_num_threads(2)

WORLDS = [1, 2, 4]
_RECORDS = {}
# the port's round against the reference's (tests/test_torch_round.py)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)


def _ranks(world, tmp_path_factory):
    """The ``rounds`` scenario on ``world`` ranks, run once per world."""
    if world not in _RECORDS:
        _RECORDS[world] = run_ranks(
            "rounds", world, tmp_path_factory.mktemp(f"rounds{world}"),
            timeout=400)
    return _RECORDS[world]


@pytest.mark.transport(timeout=480)
@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_bitexact_vs_vmap_all_compressors(world, tmp_path_factory):
    """3 engine rounds of fedavg, dgc, signSGD, STC and 3SFC in float mode,
    and fused 3SFC: bitwise the single-process round, one collective a
    round."""
    assert_check(_ranks(world, tmp_path_factory), "bitexact")


@pytest.mark.transport(timeout=480)
@pytest.mark.parametrize("world", WORLDS)
def test_ef_sharding_roundtrip_through_donation(world, tmp_path_factory):
    """The engine's state keeps each rank's EF rows across blocks, in the
    storage it was handed (donated), never writes the params it was
    handed, and its gathered EF after 4 rounds is the single-process
    one."""
    assert_check(_ranks(world, tmp_path_factory), "ef_roundtrip")


@pytest.mark.transport(timeout=480)
@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_wire_mode_equals_vmap_float(world, tmp_path_factory):
    """Codec mode (every codec, and fused 3SFC) on the sharded fan-out:
    bitwise the single-process codec round, each rank gathering exactly
    ``codec.nbytes`` frame bytes (and three f32 metrics, two when fused)
    per local client per round."""
    records = _ranks(world, tmp_path_factory)
    assert_check(records, "wire")
    assert records[0]["notes"]["wire"]["threesfc"] == 3220 + 12


@pytest.mark.transport(timeout=480)
@pytest.mark.parametrize("world", WORLDS)
def test_gathered_bytes_per_client(world, tmp_path_factory):
    """At the reference's MLP on MNIST shapes a client puts into the
    gather what a device gathers in the reference (BENCH_collectives.json,
    ``bytes_by_kind.all-gather``): 796,852 B in float mode, 3,188 B fused —
    a ratio of 249.95. (The reference's 243.56 divides its whole
    collective bytes per round, 84 B of all-reduce and permute included,
    which the port does not issue.)"""
    records = _ranks(world, tmp_path_factory)
    assert_check(records, "gathered_bytes")
    note = records[0]["notes"]["gathered_bytes"]
    assert (note["float"], note["fused"]) == (796_852, 3_188)
    assert abs(note["ratio"] - 796_852 / 3_188) < 1e-9


@pytest.mark.transport(timeout=480)
@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_fault_pipeline(world, tmp_path_factory):
    """The fault model on the sharded fan-out (the reference's tiny
    (4, 4, 1) MLP, N=8, K=1): 3 rounds at participation 0.7, drop 0.2,
    stragglers 0.3 within staleness 2 bitwise the single-process rounds
    (params, EF, the staleness ring buffer, metrics) for 3SFC, dgc,
    fedavg and signSGD codec, and fused 3SFC under dropout."""
    records = _ranks(world, tmp_path_factory)
    assert_check(records, "faults")
    assert min(records[0]["notes"]["faults"]["threesfc/float"]) < 8


@pytest.mark.transport(timeout=480)
@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_null_schedule(world, tmp_path_factory):
    """The masked pipeline under the null schedule on the sharded fan-out,
    every kind in float and codec mode and fused 3SFC in both: bitwise
    the unfaulted sharded round."""
    assert_check(_ranks(world, tmp_path_factory), "null_schedule")


@pytest.mark.transport(timeout=480)
def test_width_matched_mesh_bitexact(tmp_path_factory):
    """The reference's width-matched mesh, (data=1, model=2): one client
    shard, every rank runs all clients; 3SFC float and fused and signSGD
    codec bitwise the single-process round."""
    assert_check(_ranks(2, tmp_path_factory), "width_matched")


@pytest.mark.transport(timeout=480)
def test_train_lm_smoke_shard_map(tmp_path_factory):
    """``repro_torch.launch.train --arch mamba2-370m --smoke
    --client-parallel shard_map`` on 2 ranks: bitwise the same run's
    single-process loop, two collectives for two rounds and one for the
    final EF, rank 0 alone writing the logs."""
    assert_check(_ranks(2, tmp_path_factory), "lm_smoke")


# ---------------------------------------------------------------------------
# against the JAX reference's vmap round
# ---------------------------------------------------------------------------


@pytest.mark.transport(timeout=480)
def test_sharded_round_matches_reference_vmap(tmp_path):
    """3 rounds of 3SFC+EF on 2 ranks (float and fused decode) against the
    reference's vmap round on the same params, batches and initial D_syn
    (N=4, K=3, B=16, S=3, as tests/test_torch_round.py): params within
    rtol 1e-4 / atol 1e-6, EF within rtol 1e-4 / atol 1e-5, the metrics
    within the single-process parity test's bounds."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import CompressorConfig as JCompressorConfig
    from repro.configs.base import FLConfig as JFLConfig
    from repro.configs.run import RunConfig as JRunConfig
    from repro.core import threesfc as jthreesfc
    from repro.core.strategy import make_strategy as jmake_strategy
    from repro.data.synthetic import make_class_image_dataset as jdataset
    from repro.fl.round import build_fl_round as jbuild_round
    from repro.fl.round import fl_init as jfl_init
    from repro.models.build import vision_syn_spec as jsyn_spec
    from repro.models.cnn import MNIST_SPEC as JMNIST
    from repro.models.cnn import make_paper_model as jmodel

    n, k, b, lr, steps, rounds = 4, 3, 16, 0.05, 3, 3
    model = jmodel("mlp", JMNIST)
    params = model.init(jax.random.PRNGKey(0))
    ds = jdataset(jax.random.PRNGKey(1), 600, (28, 28, 1), 10)
    rng = np.random.default_rng(0)
    bx = np.stack([ds.x[rng.choice(600, (k, b))] for _ in range(n)])
    by = np.stack([ds.y[rng.choice(600, (k, b))] for _ in range(n)])
    batches = {"x": jnp.asarray(bx), "y": jnp.asarray(by)}
    inputs = {"n": n, "k": k, "lr": lr, "syn_steps": steps,
              "rounds": rounds, "x": bx, "y": by.astype(np.int64)}
    for layer, leaves in params.items():
        for leaf, v in leaves.items():
            inputs[f"p/{layer}/{leaf}"] = np.asarray(v)
    ccfg = JCompressorConfig(kind="threesfc", syn_steps=steps, syn_lr=0.1)
    jspec = jsyn_spec(JMNIST, ccfg)
    jstrat = jmake_strategy(ccfg, loss_fn=model.syn_loss, syn_spec=jspec,
                            local_lr=lr)
    want = {}
    for fused in (False, True):
        jround = jax.jit(jbuild_round(model.loss, jstrat, JRunConfig(
            fl=JFLConfig(num_clients=n, local_steps=k, local_lr=lr,
                         compressor=ccfg), fused_decode=fused)))
        js = jfl_init(params, n)
        key = jax.random.PRNGKey(3)
        ms = []
        for r in range(rounds):
            key, kr = jax.random.split(key)
            syns = jax.vmap(lambda kk: jthreesfc.init_syn(kk, jspec))(
                jax.random.split(kr, n))
            for i, t in enumerate(syns):
                inputs[f"syn{r}_{i}"] = np.asarray(t)
            js, jm = jround(js, batches, kr)
            ms.append(jm)
        want[fused] = (js, ms)
    np.savez(tmp_path / "reference_inputs.npz", **inputs)
    records = run_ranks("reference", 2, tmp_path, timeout=300)
    for fused in (False, True):
        tag = "fused" if fused else "float"
        assert_check(records, tag)
        got = np.load(tmp_path / f"reference_port_{tag}.npz")
        js, ms = want[fused]
        for layer, leaves in js.params.items():
            for leaf, v in leaves.items():
                np.testing.assert_allclose(got[f"p/{layer}/{leaf}"],
                                           np.asarray(v), **PARAM_TOL)
                np.testing.assert_allclose(got[f"e/{layer}/{leaf}"],
                                           np.asarray(js.ef[layer][leaf]),
                                           **EF_TOL)
        for r, jm in enumerate(ms):
            np.testing.assert_allclose(got[f"loss{r}"], float(jm.loss),
                                       rtol=1e-5)
            np.testing.assert_allclose(got[f"cos{r}"], np.asarray(jm.cosine),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got[f"norm{r}"],
                                       float(jm.update_norm), rtol=1e-4)
