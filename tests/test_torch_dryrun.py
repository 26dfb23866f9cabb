"""The allocation-free dry run (``repro_torch.launch.{specs,dryrun}``): every
entry traced on fake tensors, as the reference's tests lower theirs on a
host mesh (``test_sharding.py::test_entries_lower_on_host_mesh``,
``test_variant_lowering.py``); its product FLOPs against the reference's
analyzer on the same entry; the live-bytes model on real and fake tensors;
each hand-written kernel's meta branch; and the fan-out's gathered bytes
on a fake process group."""
import gc
import resource
import weakref

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.launch import specs as ref_specs
from repro.utils import hlo_analyzer as RH
from repro_torch.configs.base import (CompressorConfig, FLConfig, ShapeConfig,
                                      get_smoke_config)
from repro_torch.configs.run import RunConfig
from repro_torch.core.strategy import make_strategy
from repro_torch.core.tree import (tree_flatten, tree_leaves,
                                   tree_leaves_with_path, tree_map,
                                   tree_unflatten)
from repro_torch.fl import sharding
from repro_torch.fl.round import CLIENT_SCOPE, FLState, build_fl_round
from repro_torch.kernels import bitpack, ef_update, fused_cosine, sign_quant
from repro_torch.kernels import causal_attention, ssd_chunk, topk_mask
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import MNIST_SPEC, make_paper_model
from repro_torch.utils import hlo_analyzer as H

torch.set_num_threads(2)

SMALL = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 4, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
}


@pytest.fixture
def small(monkeypatch):
    for mod in (specs_lib, dryrun):
        monkeypatch.setattr(mod, "INPUT_SHAPES", SMALL)
        monkeypatch.setattr(mod, "get_config", get_smoke_config)


def _trace(arch, shape, mesh_shape, variant=None):
    """(args, trace) of one entry traced on fake CPU tensors."""
    with dryrun.fake_mesh(mesh_shape) as mesh:
        entry, args = specs_lib.make_entry(arch, shape, mesh, variant=variant)
        with FakeTensorMode():
            fake = specs_lib.materialize(args, "cpu")
            return fake, H.record(entry, *fake)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1)])
@pytest.mark.parametrize("shape", list(SMALL))
def test_entries_trace_on_fake_tensors(shape, mesh_shape, small):
    res = dryrun.run_pair("qwen1.5-0.5b", shape, mesh_shape=mesh_shape,
                          device="cpu", save=False, verbose=False)
    assert res["roofline"]["flops_per_dev"] > 0
    assert res["chips"] == mesh_shape[0]
    mem = res["memory_per_dev"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert res["top_ops_by_bytes"] and len(res["top_ops_by_bytes"]) <= 20


@pytest.mark.parametrize("variant", [
    {"fused_decode": True},
    {"ef_dtype": "bfloat16", "param_dtype": "bfloat16"},
    {"client_parallel": "shard_map", "local_steps": 2},
])
def test_train_variants_trace(variant, small):
    (state, batch, key), tr = _trace("qwen1.5-0.5b", "train_4k", (2, 1),
                                     variant)
    assert H.analyze(tr).flops > 0
    assert all(isinstance(t, FakeTensor)
               for t in tree_leaves((state.params, state.ef)))
    if variant.get("ef_dtype"):
        assert {t.dtype for t in tree_leaves(state.ef)} == {torch.bfloat16}
        assert {t.dtype for t in tree_leaves(state.params)} == \
            {torch.bfloat16}
    rows = 1 if variant.get("client_parallel") == "shard_map" else 2
    K = variant.get("local_steps", 1)
    assert tuple(batch["tokens"].shape) == (rows, K, 8 // 2, 64)
    new_state, metrics = tr.result
    assert tuple(metrics.cosine.shape) == (2,)
    assert len(tr.collectives) == (rows == 1)


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium",
                                  "mamba2-370m"])
def test_prefill_entry_traces(arch, small):
    """On a (2, 1) mesh rank 0 prefills its 4 // 2 rows of the batch."""
    args, tr = _trace(arch, "prefill_32k", (2, 1))
    logits, cache, t0 = tr.result
    cfg = get_smoke_config(arch)
    assert tuple(logits.shape) == (4 // 2, cfg.vocab_size)
    assert H.analyze(tr).flops > 0


@pytest.mark.parametrize("shape", list(SMALL))
def test_moe_entries_trace(shape, small):
    """C6: the MoE dispatch writes its one-hots without a data-dependent
    shape (it selected the kept (token, slot)s with ``nonzero``, which
    reads their count back to the host and which a fake tensor cannot
    give)."""
    _, tr = _trace("qwen3-moe-30b-a3b", shape, (1, 1))
    assert H.analyze(tr).flops > 0
    assert not any("nonzero" in o.op for o in tr.ops)


@pytest.fixture
def tp_reset():
    """The variants are process-wide, as in the reference: reset them the
    way its fixture does."""
    yield
    from repro_torch.models import params as P_, shard
    P_.set_qk_hd_fallback(True)
    shard.enable(False)


@pytest.mark.parametrize("case", ["act_shard", "no_qk_hd_shard",
                                  "model-axis", "multi-pod"])
def test_tensor_parallel_inputs_trace(case, small, tp_reset):
    """A model axis larger than 1 (a (1, 2) mesh, the multi-pod (2, 16, 16)
    mesh) and the variants act_shard and no_qk_hd_shard trace, the
    parameters as DTensor shards on the model sub-mesh."""
    if case == "multi-pod":
        res = dryrun.run_pair("qwen1.5-0.5b", "prefill_32k", multi_pod=True,
                              device="cpu", save=False, verbose=False)
        assert res["mesh"] == "2x16x16" and res["chips"] == 512
    elif case == "model-axis":
        res = dryrun.run_pair("qwen1.5-0.5b", "prefill_32k",
                              mesh_shape=(1, 2), device="cpu", save=False,
                              verbose=False)
        assert res["chips"] == 2
    else:
        args, tr = _trace("internvl2-1b", "prefill_32k", (1, 2),
                          {case: True})
        from torch.distributed.tensor import DTensor
        assert all(isinstance(t, DTensor) for t in tree_leaves(args[0]))
        assert H.analyze(tr).flops > 0 and tr.collectives
        return
    assert res["roofline"]["flops_per_dev"] > 0
    assert res["memory_per_dev"]["peak_bytes"] >= \
        res["memory_per_dev"]["argument_bytes"] > 0


def test_train_flops_track_the_reference(small, monkeypatch):
    """The port's product FLOPs on the smoke qwen1.5-0.5b train entry
    against the reference's analyzer on its compiled entry, on a (1, 1)
    mesh. The reference's specs are lowered without their shardings: on a
    one-device mesh they change nothing, and this JAX's vmap refuses the
    sharded client axis. Measured: 1,833,714,176 against 1,958,215,680
    (0.9364)."""
    monkeypatch.setattr(ref_specs, "INPUT_SHAPES", SMALL)
    monkeypatch.setattr(ref_specs, "get_config", ref_smoke_config)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    entry, args = ref_specs.make_entry("qwen1.5-0.5b", "train_4k", mesh)
    plain = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), args)
    want = RH.analyze(jax.jit(entry).lower(*plain).compile().as_text()).flops
    _, tr = _trace("qwen1.5-0.5b", "train_4k", (1, 1))
    got = H.analyze(tr).flops
    assert 0.9 <= got / want <= 1.1, (got, want, got / want)


def test_published_prefill_is_allocation_free():
    """qwen1.5-0.5b's prefill_32k at its published widths (32 x 32,768
    tokens; the f32 attention logits alone are TiBs) traces on this host
    and reports its peak; the process grows by far less than that."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    res = dryrun.run_pair("qwen1.5-0.5b", "prefill_32k", mesh_shape=(1, 1),
                          device="cpu", save=False, verbose=False)
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
             - before) * 1024
    peak = res["memory_per_dev"]["peak_bytes"]
    assert peak > 80 * 2**30
    assert grown < 2 * 2**30, grown
    assert res["roofline"]["dominant"] == "memory"


# ---------------------------------------------------------------------------
# the live-bytes model
# ---------------------------------------------------------------------------


def _program(x, w):
    h = torch.relu(x @ w)
    g = h * h
    del h
    return (g @ w.T).sum(), g.mean()


def test_live_bytes_equal_on_real_and_fake_tensors():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((96, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    real = H.record(_program, x, w)
    with FakeTensorMode() as mode:
        fake = H.record(_program, mode.from_tensor(x), mode.from_tensor(w))
    assert real.memory == fake.memory
    assert [(o.op, o.bytes) for o in real.ops] == \
        [(o.op, o.bytes) for o in fake.ops]
    assert real.memory["peak_bytes"] > real.memory["argument_bytes"]


def test_tree_walks_keep_no_leaf_alive():
    """C5: the tree walks leave no reference cycle behind, so a leaf dies
    with its last reference, the collector off (a cycle through a
    self-calling nested function held every flattened tree's leaves until
    a collection: GBs at full width, as a round's dry run showed)."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        t = torch.ones(4)
        died = []
        weakref.finalize(t, died.append, True)
        leaves, treedef = tree_flatten({"a": [t, (t,)], "b": None})
        tree_unflatten(treedef, leaves)
        tree_leaves_with_path({"a": t, "b": [t]})
        tree_map(lambda x: x, {"a": t})
        del leaves, t
        assert died == [True]
    finally:
        if collecting:
            gc.enable()


def test_live_bytes_of_a_product_are_its_three_storages():
    x, w = torch.ones(128, 64), torch.ones(64, 33)
    tr = H.record(lambda a, b: a @ b, x, w)
    block = H.BLOCK_BYTES
    sizes = [128 * 64 * 4, 64 * 33 * 4, 128 * 33 * 4]
    rounded = [-(-n // block) * block for n in sizes]
    assert tr.memory == {"argument_bytes": rounded[0] + rounded[1],
                         "output_bytes": rounded[2], "temp_bytes": 0,
                         "peak_bytes": sum(rounded)}


# ---------------------------------------------------------------------------
# the kernels' meta branches, on fake CUDA tensors
# ---------------------------------------------------------------------------

F32, U8, I32 = torch.float32, torch.uint8, torch.int32
# (wrapper call, its plain version, input (shape, dtype)s, kernel, module,
# the bytes its launch reads)
META_CASES = {
    "B1": (fused_cosine.fused_cosine, fused_cosine.fused_cosine_plain,
           [((1000,), F32), ((1000,), F32)], "fused_cosine", fused_cosine,
           2 * 4000),
    "B1-leaves": (lambda a, b, c, d: fused_cosine.fused_cosine_leaves(
        [a, b], [c, d]), lambda a, b, c, d: fused_cosine
        .fused_cosine_leaves_plain([a, b], [c, d]),
        [((1000,), F32), ((7,), F32), ((1000,), F32), ((7,), F32)],
        "fused_cosine", fused_cosine, 2 * 4028),
    "B2": (lambda u, d, s: ef_update.ef_update_leaves([u, d], [d, u], s),
           lambda u, d, s: [ef_update.ef_update_plain(u, d, s),
                            ef_update.ef_update_plain(d, u, s)],
           [((1001,), F32), ((1001,), F32), ((1,), F32)], "ef_update",
           ef_update, 4 * 4004 + 4),
    "B3a": (bitpack.pack_signs, bitpack.pack_signs_plain,
            [((1000,), F32)], "pack_signs", bitpack, 4000),
    "B3a-tree": (lambda a, b, out: bitpack.pack_signs_tree([a, b], out),
                 lambda a, b, out: bitpack.pack_signs_tree_plain([a, b]),
                 [((10, 10), F32), ((28,), F32), ((16,), U8)], "pack_signs",
                 bitpack, 4 * 128),
    "B3b": (lambda w: bitpack.unpack_signs(w, 1000),
            lambda w: bitpack.unpack_signs_plain(w, 1000),
            [((32,), I32)], "unpack_signs", bitpack, 128),
    # the sign sections, not the whole frames
    "B3b-frames": (lambda f: bitpack.unpack_signs_frames(f, 7, 100),
                   lambda f: bitpack.unpack_signs_frames_plain(
                       list(f), 7, 100),
                   [((3, 40), U8)], "unpack_signs", bitpack, 3 * 13),
    "B4": (ssd_chunk.ssd_chunk, ssd_chunk.ssd_chunk_plain,
           [((1, 2, 2, 8, 16), F32), ((1, 2, 2, 8), F32),
            ((1, 2, 8, 16), F32), ((1, 2, 8, 16), F32)], "ssd_chunk",
           ssd_chunk, 4 * (512 + 32 + 256 + 256)),
    "B5": (sign_quant.sign_quant, sign_quant.sign_quant_plain,
           [((1000,), F32)], "sign_quant", sign_quant, 4000),
    "B6": (topk_mask.topk_mask, topk_mask.topk_mask_plain,
           [((1000,), F32), ((), F32)], "topk_mask", topk_mask, 4004),
}


def _launches(mod):
    got = mod.LAUNCHES
    return dict(got) if isinstance(got, dict) else got


def _real(shape, dtype, rng):
    if dtype == F32:
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return torch.from_numpy(rng.integers(0, 100, shape).astype(
        {U8: np.uint8, I32: np.int32}[dtype]))


@pytest.mark.parametrize("case", list(META_CASES))
def test_kernel_meta_branch(case):
    """Fake CUDA tensors: the plain version's output shapes and dtypes, one
    kernel record of operand plus result bytes and 0 FLOPs, and no launch
    counted."""
    call, plain, shapes, kernel, mod, read = META_CASES[case]
    want = plain(*[_real(s, d, np.random.default_rng(0)) for s, d in shapes])
    before = _launches(mod)
    with FakeTensorMode():
        args = [torch.empty(s, dtype=d, device="cuda") for s, d in shapes]
        tr = H.record(call, *args)
    assert _launches(mod) == before
    got = tr.result
    got_l = [got] if isinstance(got, torch.Tensor) else list(got)
    want_l = [want] if isinstance(want, torch.Tensor) else list(want)
    assert [(tuple(t.shape), t.dtype) for t in got_l] == \
        [(tuple(t.shape), t.dtype) for t in want_l]
    assert all(t.device.type == "cuda" for t in got_l)
    kernels = [o for o in tr.ops if o.kernel]
    assert [o.op for o in kernels] == [kernel]
    assert kernels[0].flops == 0.0
    written = sum(t.numel() * t.element_size() for t in got_l)
    assert kernels[0].bytes == read + written


@pytest.mark.parametrize("pair", [(64, 64), (192, 128)])
def test_b7_meta_branch_counts_its_products(pair):
    """B7's meta branch (fake CUDA tensors, bf16, B = 1, S = 128, H = 4
    over 2 KV heads) reports each launch with the FLOPs of its products
    over the causal half of the logits, 128 · 129 / 2 of them a head, in
    the bf16 class, and counts no launch: the forward q·k and p·v, the
    backward's dq launch q·k, dO·v and dS·k, its dk, dv launch dSᵀ·q and
    pᵀ·dO."""
    D, DV = pair
    logits = 4 * 128 * 129 // 2
    want = {"attn_fwd": 2 * logits * (D + DV),
            "attn_bwd_dq": 2 * logits * (2 * D + DV),
            "attn_bwd_dkdv": 2 * logits * (D + DV)}
    assert want["attn_fwd"] == {64: 8_454_144, 192: 21_135_360}[D]

    def fwd_bwd(q, k, v, do):
        o, m, l = causal_attention._forward(q, k, v, 0.125)
        return (o, *causal_attention._backward(q, k, v, do, m, l, 0.125))

    before = causal_attention.LAUNCHES
    with FakeTensorMode():
        bf = torch.bfloat16
        args = [torch.empty((1, 128, h, d), dtype=bf, device="cuda")
                for h, d in ((4, D), (2, D), (2, DV), (4, DV))]
        tr = H.record(fwd_bwd, *args)
    assert causal_attention.LAUNCHES == before
    kernels = [o for o in tr.ops if o.kernel]
    assert {o.op: o.flops for o in kernels} == want
    assert causal_attention.flops(1, 128, 4, D, DV) == want
    assert {o.flop_class for o in kernels} == {"bf16"}
    assert H.analyze(tr).flops_by_class["bf16"] == sum(want.values())


# ---------------------------------------------------------------------------
# the fan-out on a fake process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,per_client", [(False, 796_852),
                                              (True, 3_188)])
def test_fanout_gathers_its_bytes_per_client(fused, per_client):
    """A shard_map 3SFC round of the paper's MLP on a fake (4, 1) group:
    one all-gather of this rank's client row, of the bytes
    ``sharding.GATHERED_BYTES`` counts (the reference's all-gather bytes),
    and no collective in the client scope."""
    model = make_paper_model("mlp", MNIST_SPEC)
    comp = CompressorConfig(kind="threesfc", syn_steps=2, syn_lr=0.1)
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.05)
    K, B = 2, 8
    with dryrun.fake_mesh((4, 1)) as mesh:
        run = RunConfig(fl=FLConfig(num_clients=4, local_steps=K,
                                    local_lr=0.05, local_batch=B,
                                    compressor=comp),
                        client_parallel="shard_map", mesh=mesh,
                        fused_decode=fused)
        fl_round = build_fl_round(model.loss, strategy, run)
        with FakeTensorMode():
            params = model.init(torch.Generator().manual_seed(0))
            ef = tree_map(lambda p: torch.zeros((1, *p.shape)), params)
            batch = {"x": torch.empty((1, K, B, *MNIST_SPEC.input_shape)),
                     "y": torch.empty((1, K, B), dtype=torch.int32)}
            gathered = sharding.GATHERED_BYTES
            tr = H.record(fl_round, FLState(params, ef, 0), batch, 0)
    gathers = [c for c in H.collectives(tr) if c.kind == "all-gather"]
    assert len(H.collectives(tr)) == len(gathers) == 1
    assert gathers[0].bytes == per_client
    assert gathers[0].dtypes == ("torch.uint8",)
    assert sharding.GATHERED_BYTES - gathered == per_client
    assert H.collectives_in_scope(tr, CLIENT_SCOPE) == []
