"""Roofline terms of one recorded run on an NVIDIA H100 — no card needed.

The JAX package reads its terms from a compiled program's per-device HLO.
The port's counterpart of a compiled program is an op trace
(``repro_torch.utils.hlo_analyzer.record``): one eager run of the entry,
on fake tensors for a dry run, recorded ATen op by ATen op. A trace is the
work of one process, so the three terms come out per device:

    compute    = Σ product FLOPs of each class / that class's peak
    memory     = operand + result bytes / HBM bandwidth
    collective = collective operand bytes / NVLink bandwidth

The product FLOPs are split by the product's dtype, since the card's
rates differ by far: an f32 product runs on the f32 pipes while
``torch.backends.cuda.matmul.allow_tf32`` is off (as the port keeps it,
for the reference's f32 numerics) and at the TF32 tensor-core rate when
the trace recorded it on; bf16 and f16 products run at the bf16 rate.

Hardware model: one H100 SXM5 at its 700 W limit, dense rates (no
sparsity), from the NVIDIA H100 Tensor Core GPU datasheet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column:
HBM_BW = 3.35e12             # bytes/s: HBM3, 3.35 TB/s
F32_FLOPS = 67e12            # FLOP/s: FP32, non-tensor
TF32_FLOPS = 494.7e12        # FLOP/s: TF32 tensor core, dense (989.4 sparse)
BF16_FLOPS = 989.4e12        # FLOP/s: BF16/FP16 tensor core, dense
NVLINK_BW = 450e9            # bytes/s a direction: NVLink, 900 GB/s total

# the peak of each product class the analyzer reports
PEAK_FLOPS: Dict[str, float] = {"f32": F32_FLOPS, "tf32": TF32_FLOPS,
                                "bf16": BF16_FLOPS}


@dataclass
class Roofline:
    flops: Dict[str, float]          # per-device product FLOPs by class
    hbm_bytes: float                 # per-device operand + result bytes
    coll_bytes: Dict[str, float]     # per-device collective operand bytes
    chips: int
    model_flops: float = 0.0         # 6·N·D useful-math estimate (global)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def compute_s(self) -> float:
        return sum(v / PEAK_FLOPS[k] for k, v in self.flops.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (global product FLOPs) — remat/redundancy waste
        probe."""
        total = self.total_flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_dev": self.total_flops,
            "flops_per_dev_by_class": dict(self.flops),
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": dict(self.coll_bytes), "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def from_trace(trace, chips: int, model_flops: float = 0.0) -> Roofline:
    """The roofline of an op trace (``hlo_analyzer.record``)."""
    from repro_torch.utils import hlo_analyzer

    tot = hlo_analyzer.analyze(trace)
    return Roofline(dict(tot.flops_by_class), tot.bytes,
                    dict(tot.coll_bytes), chips, model_flops)


def model_flops_estimate(cfg, tokens: float, mode: str = "train") -> float:
    """6·N_active·D (train) / 2·N_active·D (inference) rule of thumb."""
    d, L, ff, V = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    per_layer = 0.0
    pattern = cfg.block_pattern
    n_attn = sum(1 for b in pattern if b == "attn") / len(pattern)
    n_ssm = sum(1 for b in pattern if b == "ssm") / len(pattern)
    n_rec = sum(1 for b in pattern if b == "rec") / len(pattern)
    if n_attn:
        qkvo = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
        if cfg.num_experts:
            ffw = 3 * d * ff * (cfg.experts_per_token + cfg.shared_experts)
        else:
            ffw = 3 * d * ff
        per_layer += n_attn * (qkvo + ffw)
    if n_ssm:
        dims_inner = cfg.ssm_expand * d
        per_layer += n_ssm * (d * (2 * dims_inner + 2 * cfg.ssm_state
                                   + dims_inner // cfg.ssm_head_dim)
                              + dims_inner * d)
    if n_rec:
        w = cfg.rnn_width or d
        per_layer += n_rec * (3 * d * w + 2 * w * w + w * d + 3 * d * ff)
    n_active = L * per_layer + 2 * d * V  # embed+head
    if cfg.enc_layers:
        n_active += cfg.enc_layers * per_layer
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_active * tokens
