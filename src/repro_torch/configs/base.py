"""FL and compressor configuration: the paper's knobs.

A copy of ``CompressorConfig`` and ``FLConfig`` from the JAX package's
``configs/base.py``, field for field, so a run's configuration reads the
same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class CompressorConfig:
    kind: str = "threesfc"           # threesfc | topk | randk | signsgd | stc | identity | fedsynth
    error_feedback: bool = True      # paper Eq. 6
    # 3SFC knobs
    syn_batch: int = 1               # n data samples in D_syn (paper: 1)
    syn_seq: int = 16                # synthetic sequence length for LM-family
    syn_steps: int = 1               # S in Algorithm 1
    syn_lr: float = 0.1              # eta for the S optimization steps
    l2_coef: float = 0.0             # lambda (paper uses 0)
    soft_label_rank: int = 0         # 0 = full vocab soft labels; >0 low-rank factored
    # top-k / STC knobs
    keep_ratio: float = 0.01
    # fedsynth baseline
    unroll_steps: int = 5
    # wire-format dtype policy for the serialized payload (repro.comm):
    # fp32 (lossless) | fp16 | bf16 — applies to the 3SFC (D_syn) streams
    wire_dtype: str = "fp32"


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 8
    local_steps: int = 5             # K
    local_lr: float = 0.01
    local_batch: int = 32
    server_lr: float = 1.0           # 1.0 => plain FedAvg averaging
    rounds: int = 20
    dirichlet_alpha: float = 0.5
    aggregation: str = "mean"        # mean | weighted
    compressor: CompressorConfig = field(default_factory=CompressorConfig)
    seed: int = 0
