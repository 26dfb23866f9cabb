"""Training parity for every LM architecture of ``ARCH_IDS`` on the CPU:
tests/test_models_smoke.py's train step over all ten (its 3SFC encode is
in tests/test_torch_lm_encode.py); one 3SFC+EF round through
``build_fl_round`` at tinyllama, qwen3-moe, recurrentgemma and seamless
against the reference's, in the manner of tests/test_torch_lm_round.py;
and ``--arch ID --smoke`` on every arch. Tolerances in
tests/_torch_families.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (CPU, EF_TOL, PARAM_TOL, ROUND_ARCHS, batch_of,
                             cfg_of, close_trees, np_tree, reference,
                             torch_batch, value_and_grad)

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.run import RunConfig as JRunConfig
from repro.core import flat as jflat
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models import build as jbuild
from repro_torch.configs.base import (ARCH_IDS, CompressorConfig, FLConfig,
                                     get_smoke_config)
from repro_torch.configs.run import RunConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.core.threesfc import SynData
from repro_torch.fl.round import build_fl_round, fl_init
from repro_torch.launch import train
from repro_torch.models import build

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py over every arch
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py over every arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    cfg = get_smoke_config(arch)
    model = build.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = torch_batch(batch_of(arch, 5))
    loss, grads = value_and_grad(lambda w: model.loss(w, batch), params)
    assert np.isfinite(float(loss)), f"{arch}: NaN loss"
    gn = float(flat.tree_norm(grads))
    assert np.isfinite(gn) and gn > 0, f"{arch}: bad grads"
    p2 = flat.tree_map(lambda p, g: p - 0.05 * g, params, grads)
    with torch.no_grad():
        assert float(model.loss(p2, batch)) < float(loss)


# ---------------------------------------------------------------------------
# one federated round, and the entry points
# ---------------------------------------------------------------------------


def _finite_a(params):
    """recurrentgemma's reference init puts +inf in a_param (expm1
    overflows), which makes an SGD step's update w - w' NaN there; the
    round starts both sides from finite a in (0.5, 0.98)."""
    params = jax.tree.map(lambda x: x, params)
    for blocks in (params.get("layers", {}), params.get("tail", {})):
        for p in blocks.values():
            if "rglru" in p:
                a = p["rglru"]["a_param"]
                p["rglru"]["a_param"] = np.broadcast_to(np.linspace(
                    0.0, 4.0, a.shape[-1]), a.shape).astype(np.float32)
    return params


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_threesfc_ef_round_matchesreference(arch):
    """One 3SFC+EF round (N = 2, K = 1) from the same params, batches and
    syn0 on both sides, in the manner of tests/test_torch_lm_round.py."""
    jm, jp = reference(arch)
    jp = _finite_a(jp)
    N, K, LR = 2, 1, 0.05
    batch = batch_of(arch, 8, b=N * K * 2)
    jbatches = {k: jnp.asarray(v.reshape(N, K, 2, *v.shape[1:]))
                for k, v in batch.items()}
    tbatches = {k: torch.tensor(np.asarray(v)) for k, v in jbatches.items()}
    kw = dict(kind="threesfc", syn_steps=2, syn_lr=0.1, syn_seq=4,
              soft_label_rank=8)
    jcomp, comp = JCompressorConfig(**kw), CompressorConfig(**kw)
    jspec = jbuild.syn_spec_for(jm.cfg, jcomp)
    jstrat = jmake_strategy(jcomp, loss_fn=jbuild.syn_loss_fn(jm),
                            syn_spec=jspec, local_lr=LR)
    jround = jax.jit(jbuild_round(jm.loss, jstrat, JRunConfig(
        fl=JFLConfig(num_clients=N, local_steps=K, local_lr=LR,
                     compressor=jcomp))))
    model = build.build_model(cfg_of(arch))
    tstrat = make_strategy(comp, loss_fn=build.syn_loss_fn(model),
                           syn_spec=build.syn_spec_for(model.cfg, comp),
                           local_lr=LR)
    tround = build_fl_round(model.loss, tstrat, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=LR,
                    compressor=comp)))
    key = jax.random.PRNGKey(5)
    syns = np_tree(jax.vmap(lambda k: jthreesfc.init_syn(k, jspec))(
        jax.random.split(key, N)))
    js, jmet = jround(jfl_init(jax.tree.map(jnp.asarray, jp), N), jbatches,
                      key)
    ts, tmet = tround(fl_init(params_from_numpy(jp, CPU), N, tstrat),
                      tbatches, 0,
                      syn0=SynData(*[torch.tensor(a) for a in syns]))
    assert np.isfinite(float(tmet.loss))
    np.testing.assert_allclose(float(tmet.loss), float(jmet.loss), rtol=1e-5)
    np.testing.assert_allclose(tmet.cosine.numpy(), np.asarray(jmet.cosine),
                               rtol=1e-3, atol=1e-6)
    close_trees(ts.params, np_tree(js.params), **PARAM_TOL)
    close_trees(ts.ef, np_tree(js.ef), **EF_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_smoke_trainer_writes_reference_rows(arch, tmp_path, capsys):
    """``--arch ID --smoke --device cpu`` on every arch: one row per round
    with the reference's keys, ``params`` the smoke model's size.
    recurrentgemma's cosine is NaN, as the reference's trainer prints it
    (its a_param init holds +inf)."""
    out = tmp_path / "run"
    state = train.main(["--arch", arch, "--smoke", "--rounds", "1",
                        "--clients", "2", "--local-steps", "1", "--batch",
                        "2", "--eval-every", "1", "--device", "cpu", "--out",
                        str(out)])
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert rows == printed and [r["round"] for r in rows] == [1]
    _, jp = reference(arch)
    for r in rows:
        assert set(r) == {"round", "loss", "cos", "params"}
        assert np.isfinite(r["loss"])
        assert np.isfinite(r["cos"]) != (arch == "recurrentgemma-2b")
        assert r["params"] == jflat.tree_size(jp) == \
            flat.tree_size(state.params)
    cfg = json.load(open(os.path.join(out, "run_config.json")))
    assert cfg["arch"] == arch and cfg["seq_len"] == 64
