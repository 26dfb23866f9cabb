"""The ranks' side of tests/test_torch_tp.py: tensor parallelism over gloo.

``scenario(r)`` runs on every rank of a ``(data, model) = (world / 2, 2)``
mesh (``launch.mesh.make_host_mesh(model=2)``): (1, 2) on two ranks, (2, 2)
on four. The parent wrote ``tp_inputs.npz`` (the smoke params per case,
seeded inputs and each client's ``syn0``, all numpy) into the test's tmp
dir; each check loads its part, runs the port's entries from
``launch.specs.make_entry`` with the params placed on the ``model``
sub-mesh (``fl.sharding.place_params``), holds them to the single-process
port run in the same process, and keeps what the tensor-parallel run gave
for the parent, which holds it to the reference (``tp_out.rank<r>.npz``,
written by the last check). Spawning, the store and the record of passed
checks are tests/_torch_fanout.py's. This module imports no JAX.

Which serving case runs which branch of ``models.params.make_sharding_rules``
on the model axis of 2 (the replicate fallbacks of the shard rules are
reached only on meshes where a dimension does not divide; the spec parity
of tests/test_torch_tp_rules.py holds those, on all five meshes):

* ``tinyllama``: ``embed/table`` (vocab rows), ``lm_head/w``, ``attn/w{q,k,
  v}`` on heads (8 heads, 2 KV heads), ``attn/wo`` on heads, ``ffn/w_in``,
  ``ffn/w_gate``, ``ffn/w_out``, the ``.*`` replicate of the norms;
* ``internvl2``: 7 heads and 1 KV head, so ``_heads_then_hd``'s head_dim
  fallback for q/k/v and ``_wo``'s head_dim fallback; the tied embedding;
  ``internvl2_no_qk_hd``: ``set_qk_hd_fallback(False)``, q/k/v replicated;
  ``internvl2_act_shard``: the pins (``models.shard``);
* ``qwen15``: the q/k/v biases ``attn/b{q,k,v}``;
* ``llama4``: ``moe/(w_in|w_gate)`` and ``moe/w_out`` on experts,
  ``moe/router`` replicated, the shared expert (no rule: replicated), the
  chunked-local attention window;
* ``moe_ff_fallback``: qwen3-moe with 3 experts on a model axis of 2: the
  MoE rules' per-expert ff fallback;
* ``mamba2_pallas``: every ``ssm/*`` rule, through B4's route
  (``use_pallas_ssd``), its plain version on the CPU;
* ``recurrentgemma``: every ``rglru/*`` rule and the hybrid pattern's tail;
* ``seamless``: the enc-dec stacks (``enc_layers/``, ``dec_layers/``) and
  cross-attention.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import tree_leaves

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
PIN_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, STEPS = 4, 8, 4
TRAIN_SEQ, TRAIN_BATCH = 8, 4

# case -> (arch, variant, config overrides)
SERVE = {
    "tinyllama": ("tinyllama-1.1b", {}, {}),
    "internvl2": ("internvl2-1b", {}, {}),
    "internvl2_no_qk_hd": ("internvl2-1b", {"no_qk_hd_shard": True}, {}),
    "internvl2_act_shard": ("internvl2-1b", {"act_shard": True}, {}),
    "qwen15": ("qwen1.5-0.5b", {}, {}),
    "llama4": ("llama4-scout-17b-a16e", {}, {}),
    "moe_ff_fallback": ("qwen3-moe-30b-a3b", {}, {"num_experts": 3}),
    "mamba2_pallas": ("mamba2-370m", {}, {"use_pallas_ssd": True}),
    "recurrentgemma": ("recurrentgemma-2b", {}, {}),
    "seamless": ("seamless-m4t-medium", {}, {}),
}
# the pins on against off: heads divide, heads fall back to head_dim, the
# MoE experts
PINS = ("tinyllama", "internvl2", "llama4")
TRAIN = [(cp, fused) for cp in ("vmap", "shard_map")
         for fused in (False, True)]
# what the tensor-parallel runs gave, for the parent
OUT: dict = {}


def unflatten(z, prefix: str) -> dict:
    """The nested dict of the npz arrays under ``prefix/``, as tensors."""
    tree: dict = {}
    for name in z.files:
        if not name.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = name[len(prefix) + 1:].split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.array(z[name])
    return params_from_numpy(tree, CPU)


def _close(got, want, what: str, **tol) -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                               err_msg=what, **tol)


def _patch_shapes(specs_lib, over: dict):
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    specs_lib.INPUT_SHAPES = {
        "prefill_32k": ShapeConfig("prefill_32k", S, B, "prefill"),
        "decode_32k": ShapeConfig("decode_32k", S, B, "decode"),
        "train_4k": ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH,
                                "train")}
    specs_lib.get_config = lambda arch: get_smoke_config(arch).replace(
        **over)


def _reset_variants() -> None:
    from repro_torch.models import params as P_
    from repro_torch.models import shard
    P_.set_qk_hd_fallback(True)
    shard.enable(False)


def _rows(mesh, n: int) -> slice:
    data = mesh["data"]
    per = n // data.size()
    lo = data.get_local_rank() * per
    return slice(lo, lo + per)


def serve_tp(mesh, z, case: str, variant=None, single: bool = True):
    """(prefill logits, [decode logits]) of the TP entries on this rank's
    rows, and the single-process port's on the same rows (``None`` unless
    ``single``)."""
    from repro_torch.fl.sharding import place_params
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models.build import build_model
    from repro_torch.models.encdec import EncDec
    arch, var, over = SERVE[case]
    var = var if variant is None else variant
    _patch_shapes(specs_lib, over)
    params = unflatten(z, f"{case}/p")
    rows = _rows(mesh, B)
    ins = [torch.from_numpy(z[f"{case}/{k}"][rows])
           for k in ("frames", "prefix", "tokens") if f"{case}/{k}" in z]
    steps = torch.from_numpy(z[f"{case}/steps"][:, rows])
    try:
        entry, _ = specs_lib.make_entry(arch, "prefill_32k", mesh,
                                        variant=var)
        dent, _ = specs_lib.make_entry(arch, "decode_32k", mesh, variant=var)
        placed = place_params(params, mesh)
        logits, cache, t = entry(placed, *ins)
        tp = [logits]
        for i in range(STEPS):
            out, cache = dent(placed, cache, steps[i], t + i)
            tp.append(out)
    finally:
        _reset_variants()
    if not single:
        return tp, None, rows
    model = build_model(specs_lib.get_config(arch))
    if isinstance(model, EncDec):
        logits, cache, t = model.prefill(params, ins[0], ins[1], cache_len=S)
    elif len(ins) == 2:
        logits, cache, t = model.prefill(params, ins[1], cache_len=S,
                                         prefix_embeds=ins[0])
    else:
        logits, cache, t = model.prefill(params, ins[0], cache_len=S)
    single = [logits]
    for i in range(STEPS):
        out, cache = model.decode_step(params, cache, steps[i], t + i)
        single.append(out)
    return tp, single, rows


def check_serve(mesh, out_dir: str, case: str) -> dict:
    """Prefill and 4 decode steps: TP against the single-process port and
    against the reference, rtol/atol 1e-4; the cache stays placed."""
    z = np.load(os.path.join(out_dir, "tp_inputs.npz"))
    tp, single, rows = serve_tp(mesh, z, case)
    gap = 0.0
    for i, (a, b) in enumerate(zip(tp, single)):
        assert not hasattr(a, "placements"), "logits must leave plain"
        _close(a, b.detach().numpy(), f"{case} step {i}: TP vs port", **TOL)
        gap = max(gap, float((a - b).abs().max()))
    OUT[f"serve/{case}/logits"] = torch.stack(tp).numpy()
    OUT[f"serve/{case}/rows"] = np.arange(B)[rows]
    return {"max_abs_tp_vs_port": gap}


def check_pins(mesh, out_dir: str) -> None:
    """act_shard on against off: the same outputs within 1e-5."""
    z = np.load(os.path.join(out_dir, "tp_inputs.npz"))
    for case in PINS:
        on, _, _ = serve_tp(mesh, z, case, {"act_shard": True}, single=False)
        off, _, _ = serve_tp(mesh, z, case, {}, single=False)
        for i, (a, b) in enumerate(zip(on, off)):
            _close(a, b.numpy(), f"{case} step {i}: pins on vs off",
                   **PIN_TOL)


def check_train(mesh, out_dir: str, cp: str, fused: bool) -> dict:
    """One train_4k round of make_entry on tinyllama's smoke config: the
    TP round (params and EF placed on the model sub-mesh) against the
    single-process port round and against the reference's vmap round,
    from the same params, batches and syn0."""
    from repro_torch.core.threesfc import SynData
    from repro_torch.core.tree import tree_map
    from repro_torch.fl.round import FLState
    from repro_torch.fl.sharding import (gather_params, make_fl_shardings,
                                         place_params)
    from repro_torch.launch import specs as specs_lib
    tag = "fused" if fused else "float"
    z = np.load(os.path.join(out_dir, "tp_inputs.npz"))
    _patch_shapes(specs_lib, {})
    entry, (spec, _, _) = specs_lib.make_entry(
        "tinyllama-1.1b", "train_4k", mesh,
        variant={"client_parallel": cp, "fused_decode": fused})
    sh = make_fl_shardings(mesh)
    n = int(z["train/n"])
    rows = tree_leaves(spec.ef)[0].shape[0]
    ids = sh.local_clients(n) if cp == "shard_map" else range(n)
    assert len(ids) == rows
    params = unflatten(z, "train/p")
    ef = tree_map(lambda p: torch.zeros((rows, *p.shape)), params)
    batch = {"tokens": torch.from_numpy(
        z["train/tokens"][ids.start:ids.stop])}
    syn0 = SynData(*[torch.from_numpy(z[f"train/syn{i}"])
                     for i in range(3)])
    s1, m1 = entry(FLState(params, ef, 0), batch, 0, syn0)
    placed = FLState(place_params(params, mesh),
                     place_params(ef, mesh, client_axis=sh.axes), 0)
    s2, m2 = entry(placed, batch, 0, syn0)
    assert all(hasattr(t, "placements") for t in tree_leaves(s2.params))
    p2, e2 = gather_params(s2.params), gather_params(s2.ef)
    for a, b in zip(tree_leaves(p2), tree_leaves(s1.params)):
        _close(a, b.numpy(), f"{cp}/{tag} params: TP vs port", **PARAM_TOL)
    for a, b in zip(tree_leaves(e2), tree_leaves(s1.ef)):
        _close(a, b.numpy(), f"{cp}/{tag} EF: TP vs port", **EF_TOL)
    for got, want in ((m2.loss, m1.loss), (m2.cosine, m1.cosine)):
        _close(got, want.numpy(), f"{cp}/{tag} metrics vs port", rtol=1e-4)
    key = f"train/{cp}_{tag}"
    # the params are every rank's, the EF rows every data rank's: kept once
    if mesh.get_rank() == 0:
        for i, t in enumerate(tree_leaves(p2)):
            OUT[f"{key}/params/{i}"] = t.numpy()
    if mesh["model"].get_local_rank() == 0:
        for i, t in enumerate(tree_leaves(e2)):
            OUT[f"{key}/ef/{i}"] = t.numpy()
    OUT[f"{key}/clients"] = np.arange(ids.start, ids.stop)
    OUT[f"{key}/loss"] = m2.loss.numpy()
    OUT[f"{key}/cosine"] = m2.cosine.numpy()
    return {"cosine": m2.cosine.tolist()}


def check_donation(mesh) -> None:
    """A donating round (``donate=True``, the engine's default) writes the
    new EF into each EF leaf's local shard, in place."""
    from repro_torch.configs.base import (CompressorConfig, FLConfig,
                                          get_smoke_config)
    from repro_torch.configs.run import RunConfig
    from repro_torch.core.strategy import make_strategy
    from repro_torch.fl.round import build_fl_round, fl_init
    from repro_torch.fl.sharding import make_fl_shardings, place_params
    from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for
    cfg = get_smoke_config("tinyllama-1.1b")
    model = build_model(cfg)
    comp = CompressorConfig(kind="threesfc", syn_seq=4, soft_label_rank=2)
    strat = make_strategy(comp, loss_fn=syn_loss_fn(model),
                          syn_spec=syn_spec_for(cfg, comp), local_lr=0.01)
    rf = build_fl_round(model.loss, strat, RunConfig(fl=FLConfig(
        num_clients=2, local_steps=1, local_lr=0.01, compressor=comp)))
    whole = fl_init(model.init(torch.Generator().manual_seed(0)), 2, strat)
    # the vmap round holds every client's EF row on each rank
    state = whole._replace(
        params=place_params(whole.params, mesh),
        ef=place_params(whole.ef, mesh,
                        client_axis=make_fl_shardings(mesh).axes))
    before = [t.to_local().untyped_storage().data_ptr()
              for t in tree_leaves(state.ef)]
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 2, S),
                           generator=torch.Generator().manual_seed(1))
    new, m = rf(state, {"tokens": tokens}, 0, donate=True)
    assert np.isfinite(float(m.loss))
    assert [t.to_local().untyped_storage().data_ptr()
            for t in tree_leaves(new.ef)] == before, \
        "the EF left its donated shards"


def check_kernel_routes(mesh) -> None:
    """B1 on a mix of Shard and Replicate leaves equals the unsharded
    stats, each replicated leaf counted once, and its grad-of-grad within
    1e-5; B2 keeps every placement."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.fl.sharding import tp_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import shard
    mm = tp_mesh(mesh)
    g = torch.Generator().manual_seed(7)
    shapes = {"w": ((8, 6), Shard(1)), "m": ((4, 3), Shard(0)),
              "b": ((6,), Replicate()), "s": ((), Replicate())}
    a = {k: torch.randn(s, generator=g) for k, (s, _) in shapes.items()}
    b = {k: torch.randn(s, generator=g) for k, (s, _) in shapes.items()}

    def placed(t):
        return {k: shard.place(v, mm, shapes[k][1]) for k, v in t.items()}

    want = ops.tree_fused_stats(a, b)
    got = ops.tree_fused_stats(placed(a), placed(b))
    assert isinstance(got, DTensor) and got.placements == (Replicate(),)
    _close(got.full_tensor(), want.numpy(), "B1 mixed", rtol=1e-6, atol=1e-6)
    rep = {k: v for k, v in a.items() if shapes[k][1] == Replicate()}
    once = ops.tree_fused_stats(
        {k: shard.place(v, mm, Replicate()) for k, v in rep.items()},
        {k: shard.place(v, mm, Replicate()) for k, v in rep.items()})
    _close(once.full_tensor(), ops.tree_fused_stats(rep, rep).numpy(),
           "B1 replicated leaves once", rtol=1e-6, atol=1e-6)

    def second(tree_a, tree_b):
        """d/da of ‖d(a·b · ‖a‖²)/da‖², through B1 twice."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in tree_a.items()}
        st = ops.tree_fused_stats(leaves, tree_b)
        st = st.full_tensor() if isinstance(st, DTensor) else st
        grads = torch.autograd.grad(st[0] * st[1], list(leaves.values()),
                                    create_graph=True)
        obj = sum((gr * gr).sum() for gr in grads)
        obj = obj.full_tensor() if isinstance(obj, DTensor) else obj
        return [shard.leave(t) for t in
                torch.autograd.grad(obj, list(leaves.values()))]

    for x, y in zip(second(a, b), second(placed(a), placed(b))):
        _close(y, x.numpy(), "B1 grad-of-grad", rtol=1e-5, atol=1e-5)
    s = torch.tensor(0.37)
    new = ops.tree_ef_update(placed(a), placed(b), s)
    plain = ops.tree_ef_update(a, b, s)
    for k in a:
        assert new[k].placements == (shapes[k][1],), k
        _close(new[k].full_tensor(), plain[k].numpy(), f"B2 {k}",
               rtol=1e-6, atol=1e-6)


def scenario(r) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    # six ranks of two worlds run at once beside the parent's reference
    # runs: one thread each keeps them from crowding the host's cores
    torch.set_num_threads(1)
    mesh = make_host_mesh(model=2, device="cpu")
    for case in SERVE:
        r.check(f"serve_{case}", check_serve, mesh, r.out, case)
    r.check("pins", check_pins, mesh, r.out)
    for cp, fused in TRAIN:
        r.check(f"train_{cp}_{'fused' if fused else 'float'}", check_train,
                mesh, r.out, cp, fused)
    r.check("donation", check_donation, mesh)
    r.check("kernel_routes", check_kernel_routes, mesh)
    r.check("save", lambda: np.savez(
        os.path.join(r.out, f"tp_out.rank{r.rank}.npz"), **OUT))
