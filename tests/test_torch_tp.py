"""Tensor parallelism on a ``model`` axis over gloo ranks on the CPU: the
port's entries (``launch.specs.make_entry``) with every parameter and EF
leaf a ``DTensor`` on the ``model`` sub-mesh, held to the single-process
port and to the JAX reference from the same numpy weights.

Two worlds, one spawn each, run at once (tests/_torch_fanout.py,
tests/_torch_tp.py): two ranks as a (1, 2) mesh and four as (2, 2). On
each rank:

* serving — the prefill and 4 decode steps of every case of
  ``_torch_tp.SERVE`` (its docstring lists which case runs which branch of
  the sharding rules) on this rank's ``B / data`` rows, rtol/atol 1e-4
  against the single-process port; the pins (``act_shard``) on against
  off within 1e-5;
* training — one ``train_4k`` round of tinyllama-1.1b's smoke config in
  ``'vmap'`` and ``'shard_map'``, with and without fused decode, against
  the port's single-process round: params rtol 1e-4 / atol 1e-6, EF rtol
  1e-4 / atol 1e-5, loss and cosine rtol 1e-4 (the bounds of
  tests/test_torch_lm_round.py);
* donation — a donating round writes each EF leaf's local shard in place;
* the kernel routes — B1 on ``Shard`` and ``Replicate`` leaves, its
  grad-of-grad, and B2's placements.

While the ranks run, the parent computes the reference's outputs from the
same inputs; then it holds each rank's tensor-parallel outputs to them:
the logits rtol/atol 1e-4 (the CPU tests' block bound), the round to the
reference's float vmap round by the bounds above (fused decode against it
too: the reference holds its fused round to its float one by them,
tests/test_fused_decode.py). mamba2's reference is its plain scan, the B4
route's oracle; the port's case runs B4's plain version. The params are
drawn by the port's init and handed to both sides as numpy."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp as tp
from _torch_fanout import assert_check, collect, start_ranks
from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.configs.run import RunConfig as JRunConfig
from repro.core import threesfc as jthreesfc
from repro.core.strategy import make_strategy as jmake_strategy
from repro.fl.round import build_fl_round as jbuild_round
from repro.fl.round import fl_init as jfl_init
from repro.models.build import build_model as jbuild_model
from repro.models.build import syn_loss_fn as jsyn_loss_fn
from repro.models.build import syn_spec_for as jsyn_spec_for
from repro.models.encdec import EncDec as JEncDec
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import to_numpy
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.models.build import build_model

torch.set_num_threads(2)

WORLDS = (2, 4)
CHECKS = ([f"serve_{c}" for c in tp.SERVE] + ["pins"]
          + [f"train_{cp}_{'fused' if f else 'float'}" for cp, f in tp.TRAIN]
          + ["donation", "kernel_routes", "save"])
TRAIN_KEYS = [f"{cp}_{'fused' if f else 'float'}" for cp, f in tp.TRAIN]
COMP = dict(kind="threesfc", syn_seq=16, soft_label_rank=8)


def _np_params(arch: str, over: dict, prefix: str) -> dict:
    cfg = get_smoke_config(arch).replace(**over)
    params = to_numpy(build_model(cfg).init(torch.Generator().manual_seed(0)))
    return {prefix + "/" + "/".join(map(str, p)): a
            for p, a in tree_leaves_with_path(params)}


def _tree(z: dict, prefix: str):
    tree: dict = {}
    for name, a in z.items():
        if name.startswith(prefix + "/"):
            node = tree
            *path, leaf = name[len(prefix) + 1:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(a)
    return tree


def _jcfg(arch, over):
    # the reference's mamba2 runs its plain scan, the B4 route's oracle
    over = {k: v for k, v in over.items() if k != "use_pallas_ssd"}
    return jget_smoke_config(arch).replace(**over)


def _serve_inputs() -> dict:
    out = {}
    for case, (arch, _, over) in tp.SERVE.items():
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(11)
        out[f"{case}/tokens"] = rng.integers(
            0, cfg.vocab_size, (tp.B, tp.S)).astype(np.int32)
        out[f"{case}/steps"] = rng.integers(
            0, cfg.vocab_size, (tp.STEPS, tp.B)).astype(np.int32)
        mm = rng.standard_normal((tp.B, cfg.num_mm_tokens, cfg.d_model)) \
            .astype(np.float32)
        if cfg.enc_layers:
            out[f"{case}/frames"] = mm
        elif cfg.num_mm_tokens:
            out[f"{case}/prefix"] = mm
        out.update(_np_params(arch, over, f"{case}/p"))
    return out


def _train_inputs(n: int) -> dict:
    """tinyllama's smoke params, ``n`` clients' batches and their syn0 as
    the reference's round draws them from its key."""
    cfg = jget_smoke_config("tinyllama-1.1b")
    spec = jsyn_spec_for(cfg, JCompressorConfig(**COMP))
    syns = jax.vmap(lambda k: jthreesfc.init_syn(k, spec))(
        jax.random.split(jax.random.PRNGKey(3), n))
    rng = np.random.default_rng(5)
    out = {"train/n": np.asarray(n),
           "train/tokens": rng.integers(
               0, cfg.vocab_size, (n, 1, tp.TRAIN_BATCH // n, tp.TRAIN_SEQ))
           .astype(np.int32)}
    out.update({f"train/syn{i}": np.asarray(t) for i, t in enumerate(syns)})
    out.update(_np_params("tinyllama-1.1b", {}, "train/p"))
    return out


def _serve_reference(z: dict, case: str) -> np.ndarray:
    """The reference's prefill and 4 decode steps' logits (5, B, V)."""
    arch, _, over = tp.SERVE[case]
    jm = jbuild_model(_jcfg(arch, over))
    params = _tree(z, f"{case}/p")
    tokens = jnp.asarray(z[f"{case}/tokens"])
    prefill = jax.jit(functools.partial(jm.prefill, cache_len=tp.S))
    if isinstance(jm, JEncDec):
        logits, cache, t = prefill(params, jnp.asarray(z[f"{case}/frames"]),
                                   tokens)
    elif f"{case}/prefix" in z:
        logits, cache, t = prefill(params, tokens, prefix_embeds=jnp.asarray(
            z[f"{case}/prefix"]))
    else:
        logits, cache, t = prefill(params, tokens)
    decode = jax.jit(jm.decode_step)
    seq = [np.asarray(logits)]
    for i in range(tp.STEPS):
        logits, cache = decode(params, cache,
                               jnp.asarray(z[f"{case}/steps"][i]), t + i)
        seq.append(np.asarray(logits))
    return np.stack(seq)


def _serve_references(z: dict) -> dict:
    """Every case's reference logits; the cases of one arch and config
    (variants only change the layout) share one run."""
    refs, by_model = {}, {}
    for case, (arch, _, over) in tp.SERVE.items():
        key = (arch, tuple(sorted(over.items())))
        if key not in by_model:
            by_model[key] = _serve_reference(z, case)
        refs[case] = by_model[key]
    return refs


def _train_reference(z: dict):
    """The reference's float vmap round of make_train_entry's defaults (K =
    1, local lr 0.01, 3SFC with 16 synthetic positions and rank-8 labels)
    on the same params, batches and key."""
    cfg = jget_smoke_config("tinyllama-1.1b")
    jm = jbuild_model(cfg)
    comp = JCompressorConfig(**COMP)
    strat = jmake_strategy(comp, loss_fn=jsyn_loss_fn(jm),
                           syn_spec=jsyn_spec_for(cfg, comp), local_lr=0.01)
    n = int(z["train/n"])
    rf = jbuild_round(jm.loss, strat, JRunConfig(fl=JFLConfig(
        num_clients=n, local_steps=1, local_lr=0.01, compressor=comp)))
    state, m = rf(jfl_init(_tree(z, "train/p"), n),
                  {"tokens": jnp.asarray(z["train/tokens"])},
                  jax.random.PRNGKey(3))
    return (jax.tree.map(np.asarray, state), np.asarray(m.loss),
            np.asarray(m.cosine))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' ranks, started at once; the reference's outputs,
    computed meanwhile. {world: (records, rank outputs, serve refs, train
    ref)}."""
    serve = _serve_inputs()
    started = {}
    try:
        for w in WORLDS:
            out = tmp_path_factory.mktemp(f"tp{w}")
            z = {**serve, **_train_inputs(w // 2)}
            np.savez(os.path.join(out, "tp_inputs.npz"), **z)
            started[w] = (start_ranks("tp", w, out), out, z)
        refs = _serve_references(serve)
        train = {w: _train_reference(z) for w, (_, _, z) in started.items()}
        got = {}
        for w, (ranks, out, _) in started.items():
            records = collect(ranks, "tp", w, out, timeout=300)
            outs = [dict(np.load(p)) if os.path.exists(p) else {} for p in
                    (os.path.join(out, f"tp_out.rank{r}.npz")
                     for r in range(w))]
            got[w] = (records, outs, refs, train[w])
    finally:
        for ranks, _, _ in started.values():
            ranks.kill()
    return got


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel(runs, world, check):
    """The check passed on every rank (TP against the single-process
    port)."""
    assert_check(runs[world][0], check)


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("case", list(tp.SERVE))
@pytest.mark.parametrize("world", WORLDS)
def test_serving_matches_reference(runs, world, case):
    records, outs, refs, _ = runs[world]
    assert_check(records, "save")
    for out in outs:
        rows = out[f"serve/{case}/rows"]
        np.testing.assert_allclose(out[f"serve/{case}/logits"],
                                   refs[case][:, rows], rtol=1e-4, atol=1e-4)


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("key", TRAIN_KEYS)
@pytest.mark.parametrize("world", WORLDS)
def test_training_matches_reference(runs, world, key):
    records, outs, _, (state, loss, cosine) = runs[world]
    assert_check(records, "save")
    params = jax.tree.leaves(state.params)
    ef = jax.tree.leaves(state.ef)
    k = f"train/{key}"
    for i, want in enumerate(params):           # kept by rank 0
        np.testing.assert_allclose(outs[0][f"{k}/params/{i}"], want,
                                   rtol=1e-4, atol=1e-6)
    held = [out for out in outs if f"{k}/ef/0" in out]
    assert len(held) == world // 2              # one per data rank
    for out in held:
        ids = out[f"{k}/clients"]
        for i, want in enumerate(ef):
            np.testing.assert_allclose(out[f"{k}/ef/{i}"], want[ids],
                                       rtol=1e-4, atol=1e-5)
    for out in outs:
        np.testing.assert_allclose(out[f"{k}/loss"], loss, rtol=1e-4)
        np.testing.assert_allclose(out[f"{k}/cosine"], cosine, rtol=1e-4)
