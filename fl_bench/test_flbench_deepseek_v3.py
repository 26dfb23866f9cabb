"""The Moonlight-16B-A3B cell's pieces on the CPU: a small Moonlight cell
added as files beside the small cells of ``make_tiny_bench`` and run
through the harness's ``run_cell`` in f32 against the plain reference
(``families/deepseek_v3.py``) within the other families' tolerances; its
weights in the layout of the port's ``model.init``; the cut's parameter
count; the FLOP count by hand; the new readers on traced rounds; the
real cell's limits against the faults of ``test_flbench_faults.py``
planted in the program and the fp8 control at small widths. The test
marked ``card`` holds the cell's limits to the fp8 control at the cell's
own size."""
import json
import math
from pathlib import Path

import pytest
import torch

import flb_check
import flb_data
import flb_harness
from flb_prec import Prec
from flb_testkit import make_tiny_bench
from test_flbench_faults import FAULTS
from test_flbench_reference import TOL

HERE = Path(__file__).resolve().parent
REAL = "moonlight-16b-a3b"
CELL = "tiny." + REAL
# d 64, 4 heads (q·k 16 + 8, v 16), latent 32, dense FFN 96, experts of
# 32: 4 of the router's 8 held (2..5), 3 a token, 1 shared; 3 layers
TINY = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            num_hidden_layers=3, n_routed_experts=4, num_experts_per_tok=3,
            n_shared_experts=1, vocab_size=256)
TINY_DEPLOYMENT = dict(router_experts=8, held_expert_start=2)
SEED = 2 ** 31 + 7


def add_tiny_cell(bench: Path, dtype: str = "float32",
                  real_limits: bool = False) -> None:
    """The small Moonlight cell ``tiny.moonlight-16b-a3b`` as files beside
    the others, on the small traffic mix, with loose limits or the real
    cell's."""
    cfg = json.loads((HERE / "configs" / f"{REAL}.json").read_text())
    cfg.update(TINY)
    cfg["deployment"].update(TINY_DEPLOYMENT)
    cfg["assumed"]["compute_dtype"] = dtype
    (bench / "configs" / f"{CELL}.json").write_text(json.dumps(cfg))
    limits = {"loss": 1.0, "ef": 1.0}
    if real_limits:
        limits = json.loads((HERE / "cells" / f"{REAL}.fl3sfc.t4096.json")
                            .read_text())["limits"]
    cell = {"config": CELL, "traffic": "tiny", "chips": 1,
            "why": "small widths on the CPU", "limits": limits}
    (bench / "cells" / f"{CELL}.json").write_text(json.dumps(cell))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = make_tiny_bench(tmp_path_factory.mktemp("dsv3"))
    add_tiny_cell(root)
    return flb_harness.Bench(root)


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry and a disabled process tracer, restored
    after the test."""
    from repro_torch.obs import Tracer, meters, trace
    reg = meters.MetricsRegistry()
    monkeypatch.setattr(meters, "_GLOBAL", reg)
    monkeypatch.setattr(trace, "_GLOBAL", Tracer(enabled=False))
    return reg


def test_reference_agrees_with_program(bench):
    torch.manual_seed(0)
    torch.set_num_threads(2)
    out = flb_harness.run_cell(bench, CELL, SEED, 0.05, False,
                               torch.device("cpu"), 0.0)
    for name, tol in TOL.items():
        assert out["values"][name] <= tol, (name, out["values"])
    res = out["result"]
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"round_s", "setup_s"}
    # the held experts moved: their leaves are among those compared
    moved = flb_check.moved(out["reference"][0]["delta"])
    assert {"layers/0/moe/w_in", "lead/0/mla/wkv_b"} <= set(moved)
    # the selection bias is never updated
    assert out["reference"][0]["delta"]["layers/0/moe/score_bias"] == 0.0
    assert out["program"][0]["delta"]["layers/0/moe/score_bias"] == 0.0


def test_weights_in_the_program_layout(bench):
    """The benchmark's weights have the leaves, shapes and dtype of the
    port's ``model.init`` at the same configuration."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.build import build_model
    c = bench.cell(CELL)
    model = build_model(ModelConfig(name=CELL,
                                    **c.family.program_config(c.cfg)))
    ours = flb_data.make_weights(c.family.param_specs(c.cfg), 3,
                                 torch.device("cpu"))
    theirs = flb_data.flatten(model.init(torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    assert all(v.dtype == theirs[k].dtype for k, v in ours.items())
    assert tuple(ours["layers/0/moe/router"].shape) == (2, 64, 8)
    assert tuple(ours["layers/0/moe/w_in"].shape) == (2, 4, 64, 32)


def _count(specs, prefix=""):
    return sum(math.prod(s) for p, s, _ in specs if p.startswith(prefix))


def test_published_cut_parameter_count():
    """d of 3SFC at the cell's size: 769,296,256, by part."""
    cfg = json.loads((HERE / "configs" / f"{REAL}.json").read_text())
    fam = flb_harness.load_module(HERE / "families" / "deepseek_v3.py",
                                  "flb_family_deepseek_v3")
    specs = fam.param_specs(cfg)
    assert _count(specs) == cfg["parameters"] == 769_296_256
    assert _count(specs, "lead/0/") == 82_973_184
    moe_layers = _count(specs, "layers/0/")
    assert moe_layers == 6 * 100_405_824
    assert _count(specs, "lead/0/mla/") + _count(specs, "lead/0/ln") == \
        13_767_168
    assert _count(specs, "embed/") + _count(specs, "lm_head/") == 83_886_080
    assert _count(specs, "final_norm/") == 2048
    assert cfg["reduced"] == ["num_hidden_layers", "n_routed_experts",
                              "vocab_size"]
    assert cfg["deployment"]["router_experts"] == 64


def test_forward_flops_by_hand(bench):
    c = bench.cell(CELL)
    # MLA: q 64·4·24, kv_a 64·40, kv_b 32·4·32, o 4·16·64; dense FFN
    # 3·64·96; MoE: router 64·8, shared 3·64·32, held 3·64·32 at 3·4/8
    mla = 64 * 96 + 64 * 40 + 32 * 128 + 64 * 64
    moe = 64 * 8 + 3 * 64 * 32 + 3 * 64 * 32 * 3 * 4 / 8
    per_token = 2 * (3 * mla + 3 * 64 * 96 + 2 * moe + 256 * 64)
    attn = 3 * 40 ** 2 * 4 * (24 + 16)
    assert c.family.forward_flops(c.cfg, 40, 3) == 3 * (40 * per_token
                                                        + attn)
    syn = c.family.forward_flops(c.cfg, 4, 1) + 2 * 4 * 2 * 256
    assert c.family.syn_forward_flops(c.cfg, 1, 4, 2) == syn


def test_readers_read_the_layers_of_traced_rounds(bench, registry):
    """The two span readers and the load reader against the registry of
    three traced rounds: the host ms of each layer span folded per round,
    no device ms on the CPU, the held slots' counts read at the settles."""
    from repro_torch.obs import configure_tracer
    torch.set_num_threads(2)
    cell = bench.cell(CELL)
    prog = flb_harness.Program(cell, SEED, torch.device("cpu"),
                               flb_harness.cell_tokens(cell, SEED,
                                                       torch.device("cpu")))
    prog.round()
    for m in ("mla.attention.device_ms", "moe.routed.device_ms",
              "moe.load_imbalance"):
        assert bench.reader(m)({}) is None        # tracing off: nothing
    configure_tracer(True)
    for _ in range(3):
        prog.round()
    configure_tracer(False)
    snap = registry.snapshot()
    for span in ("mla.attention", "moe.routed"):
        assert snap["histograms"][f"{span}_ms"]["count"] == 3
        assert bench.reader(f"{span}.device_ms")({}) is None
    counts = bench.reader("moe.load_imbalance").__globals__["held_counts"]()
    assert sorted(counts) == [0, 1, 2, 3]
    total = snap["counters"]["moe.slots"]
    assert total > sum(counts.values()) > 0 and total % 3 == 0
    share = bench.reader("moe.load_imbalance").__globals__["held_share"]()
    assert 0.2 < share < 0.8                      # 4 of 8 held
    got = bench.reader("moe.load_imbalance")({})
    assert got == max(counts.values()) / (sum(counts.values()) / 4)
    assert got >= 1.0


@pytest.fixture(scope="module")
def limited(tmp_path_factory):
    """The small cell under the real cell's limits, f32 and bf16."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        root = make_tiny_bench(tmp_path_factory.mktemp("dsv3" + dtype))
        add_tiny_cell(root, dtype, real_limits=True)
        out[dtype] = flb_harness.Bench(root)
    return out


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_cells_limits(limited, fault, monkeypatch):
    """None passes; a state, params or residuals left as they were, half
    the batch, client 0's residual ×1.5 and its scale ×2 each fail."""
    torch.set_num_threads(2)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = flb_harness.run_cell(limited["float32"], CELL, SEED, 0.0, False,
                               torch.device("cpu"), 0.0)
    assert out["result"]["correct"] is (fault == "none"), out["values"]


def test_control_fails_at_small_size(limited):
    cell = limited["bfloat16"].cell(CELL)
    cpu = torch.device("cpu")
    tokens = flb_harness.cell_tokens(cell, SEED, cpu)
    ref = flb_harness.reference_records(cell, SEED, cpu, tokens,
                                        prec=Prec(torch.bfloat16))
    ctl = flb_harness.reference_records(cell, SEED, cpu, tokens,
                                        prec=Prec(torch.bfloat16, fp8=True))
    ok, rows = flb_check.verdict(flb_check.gaps(ctl, ref),
                                 cell.spec["limits"])
    assert not ok, rows


@pytest.mark.card
def test_fp8_control_fails_the_cells_limits(card):
    """At the cell's own size the reference with fp8 products, read
    against the reference, fails the cell's limits."""
    bench = flb_harness.Bench()
    cell = bench.cell(f"{REAL}.fl3sfc.t4096")
    seed = 2 ** 31 + 101
    tokens = flb_harness.cell_tokens(cell, seed, card)
    ref = flb_harness.reference_records(cell, seed, card, tokens)
    ctl = flb_harness.reference_records(cell, seed, card, tokens,
                                        prec=Prec(torch.bfloat16, fp8=True))
    correct, rows = flb_check.verdict(flb_check.gaps(ctl, ref),
                                      cell.spec["limits"])
    assert not correct, rows
