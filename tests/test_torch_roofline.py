"""The H100 roofline (``repro_torch.utils.roofline``): its terms at the
datasheet constants, ``model_flops_estimate`` equal to the reference's for
every architecture, and the roofline of a recorded trace."""
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.utils.roofline import model_flops_estimate as ref_estimate
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.utils import hlo_analyzer as H
from repro_torch.utils.roofline import (BF16_FLOPS, F32_FLOPS, HBM_BW,
                                        NVLINK_BW, PEAK_FLOPS, TF32_FLOPS,
                                        Roofline, from_trace,
                                        model_flops_estimate)

torch.set_num_threads(2)


@pytest.mark.parametrize("cls", ["f32", "tf32", "bf16"])
def test_roofline_terms(cls):
    chips = 4
    r = Roofline(flops={cls: PEAK_FLOPS[cls]}, hbm_bytes=HBM_BW,
                 coll_bytes={"all-reduce": NVLINK_BW}, chips=chips,
                 model_flops=PEAK_FLOPS[cls] * chips * 0.5)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 1.0) < 1e-9
    assert abs(r.useful_ratio - 0.5) < 1e-9


def test_h100_datasheet_constants():
    assert (HBM_BW, F32_FLOPS, TF32_FLOPS, BF16_FLOPS, NVLINK_BW) == \
        (3.35e12, 67e12, 494.7e12, 989.4e12, 450e9)
    # compute is the sum of the classes' times
    r = Roofline({"f32": F32_FLOPS, "bf16": BF16_FLOPS}, 0.0, {}, 1)
    assert abs(r.compute_s - 2.0) < 1e-12 and r.dominant == "compute"
    assert r.total_flops == F32_FLOPS + BF16_FLOPS


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_the_reference(arch, mode):
    """Pure arithmetic on the config: exactly the reference's value."""
    got = model_flops_estimate(get_config(arch), 1e6, mode)
    assert got == ref_estimate(ref_get_config(arch), 1e6, mode)


def test_model_flops_estimate_dense_vs_moe():
    dense = model_flops_estimate(get_config("tinyllama-1.1b"), 1e6)
    # tinyllama ~1.1B params -> 6*N*D ~ 6.6e15 for 1M tokens
    assert 4e15 < dense < 9e15
    moe = model_flops_estimate(get_config("qwen3-moe-30b-a3b"), 1e6)
    moe_total_like = model_flops_estimate(
        get_config("qwen3-moe-30b-a3b").replace(num_experts=0,
                                                experts_per_token=0,
                                                d_ff=768 * 128), 1e6)
    assert moe < 0.3 * moe_total_like     # active << total for 8/128 experts


def test_from_trace_reads_the_analyzer():
    a, b = torch.ones(64, 32), torch.ones(32, 16, dtype=torch.bfloat16)
    tr = H.record(lambda x, y: (x @ x.T, y.T @ y), a, b)
    r = from_trace(tr, chips=2, model_flops=1.0)
    tot = H.analyze(tr)
    assert r.flops == {"f32": 2 * 64 * 32 * 64, "bf16": 2 * 16 * 32 * 16}
    assert r.hbm_bytes == tot.bytes and r.chips == 2
    assert r.as_dict()["flops_per_dev"] == tot.flops
    assert r.useful_ratio == 1.0 / (2 * tot.flops)
