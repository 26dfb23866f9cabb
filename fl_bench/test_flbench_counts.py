"""The benchmark's FLOP and byte counts against hand counts at a small
configuration of each family."""
import json
from pathlib import Path

import pytest

import flb_harness
from flb_testkit import make_tiny_bench

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return flb_harness.Bench(make_tiny_bench(tmp_path_factory.mktemp("c")))


def test_qwen2_counts(bench):
    c = bench.cell("tiny.qwen1.5-0.5b")
    # d 64, 4 heads of 16, 2 KV heads, ff 128, 2 layers, vocab 256
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    per_token = 2 * (2 * per_layer + 256 * 64)
    attn = 2 * 2 * 40 ** 2 * 64                  # 2 layers, causal half
    assert c.family.forward_flops(c.cfg, 40, 3) == 3 * (40 * per_token
                                                        + attn)
    syn = c.family.forward_flops(c.cfg, 4, 1) + 2 * 4 * 2 * 256
    assert c.family.syn_forward_flops(c.cfg, 1, 4, 2) == syn
    mfu = bench.reader("mfu").__globals__["round_flops"]
    # 2 clients: K = 1 step of 2 sequences at 3 forwards; 8 + 3 + 3 at syn
    assert mfu(c) == 2 * (3 * (2 * (40 * per_token + attn)) + 14 * syn)
    d = (256 * 64 + 64 + 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 64 + 2 * 32
                              + 3 * 64 * 128 + 2 * 64))
    assert _d(c) == d


def test_mamba2_counts(bench):
    c = bench.cell("tiny.mamba2-370m")
    # d 64, d_inner 128, 8 heads of 16, state 16, conv 4, chunk 16,
    # vocab 250 padded to 256
    assert c.family.vocab_rows(c.cfg) == 256
    proj = 2 * 64 * (2 * 128 + 2 * 16 + 8) + 2 * 128 * 64 \
        + 2 * 4 * (128 + 32)
    ssd = 3 * (16 * 16 * 16 + 16 * 16 * 8 * 16 + 4 * 16 * 16 * 8 * 16)
    per_seq = 40 * (2 * proj + 2 * 256 * 64) + 2 * ssd     # 3 chunks
    assert c.family.forward_flops(c.cfg, 40, 2) == 2 * per_seq
    d = 256 * 64 + 64 + 2 * (64 + 64 * 296 + 4 * 160 + 160 + 3 * 8 + 128
                             + 128 * 64)
    assert _d(c) == d


def _d(cell):
    import math
    return sum(math.prod(s) for _, s, _ in cell.family.param_specs(cell.cfg))


def test_roofline_bytes_and_peaks(bench):
    c = bench.cell("tiny.qwen1.5-0.5b")
    d = _d(c)
    b1 = bench.reader("fused_cosine_roofline").__globals__["tree_bytes"]
    b2 = bench.reader("ef_update_roofline").__globals__["tree_bytes"]
    assert b1(c) == 8 * d and b2(c) == 12 * d
    import flb_peaks
    assert flb_peaks.BF16_FLOPS == 989.4e12 and flb_peaks.HBM_BW == 3.35e12
    trace = {"rounds": 1, "window_s": 2.0, "busy_s": 0.5, "records": 10,
             "by_name": {"fused_cosine_table(x)": [8 * d / 3.35e12 * 2, 2]}}
    run = {"cell": c, "trace": trace, "window_s": 4.0, "rounds": 2,
           "launches": {"fused_cosine": 2, "ef_update": 0}}
    assert bench.reader("fused_cosine_roofline")(run) == pytest.approx(100.0)
    assert bench.reader("ef_update_roofline")(run) is None
    run["launches"]["fused_cosine"] = 3     # the counter disagrees
    assert bench.reader("fused_cosine_roofline")(run) is None
    assert bench.reader("device.idle_share")(run) == pytest.approx(75.0)
    assert bench.reader("device.kernels_per_round")(run) == 10


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mamba2-370m"])
def test_published_parameter_counts(bench, name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    fam = flb_harness.load_module(HERE / "families" / f"{cfg['family']}.py",
                                  "flb_family_" + cfg["family"])
    import math
    assert sum(math.prod(s) for _, s, _ in fam.param_specs(cfg)) == \
        cfg["parameters"]
