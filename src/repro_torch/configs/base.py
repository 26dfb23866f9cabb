"""Model, FL and compressor configuration, and the architecture registry.

A copy of ``ModelConfig``, ``CompressorConfig``, ``FLConfig`` and
``ShapeConfig`` (with the ``INPUT_SHAPES`` it names) from the JAX
package's ``configs/base.py``, field for field, so a run's
configuration reads the same in both packages; ``ModelConfig`` adds the
port-only fields of ``PORT_FIELDS`` after the reference's, at defaults
that leave a config the reference's. Every architecture of ``ARCH_IDS``
has a module in this package defining ``CONFIG`` (the published widths)
and ``smoke_config()`` (the reduced CPU-test variant), field for field
the reference's; ``PORT_ARCH_IDS`` lists the port's own architectures
(no JAX twin), resolved the same way; ``get_config``/``get_smoke_config``
resolve dash or underscore ids.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Tuple

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    shared_experts: int = 0          # always-on shared expert count (llama4: 1, moonlight: 2)
    moe_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    use_pallas_ssd: bool = False     # route the SSD inner chunk through the
                                     # hand-written kernel (B4, ``ssd_chunk``)
    # --- hybrid block pattern, repeated to cover num_layers ---
    # entries: "attn" (attention + FFN), "ssm" (mamba2 mixer), "rec" (RG-LRU + FFN)
    block_pattern: Tuple[str, ...] = ("attn",)
    rnn_width: int = 0               # RG-LRU recurrent width (0 -> d_model)
    # --- attention ---
    rope_theta: float = 10000.0
    attn_window: int = 0             # 0 = full causal; >0 = sliding window
    # --- encoder-decoder ---
    enc_layers: int = 0              # >0 -> enc-dec model (num_layers = decoder)
    # --- multimodal frontend stub ---
    modality: str = "text"           # text | vision | audio
    num_mm_tokens: int = 0           # stub patch/frame embeddings prepended
    # --- numerics ---
    param_dtype: str = "float32"
    dtype: str = "bfloat16"          # activation/compute dtype
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- scan/remat ---
    remat: bool = True
    source: str = ""                 # citation
    # --- port-only (no JAX twin; every ARCH_IDS config leaves them at
    # PORT_FIELDS' defaults) ---
    # multi-head latent attention (block type "mla"), the un-absorbed
    # training form: q to H x (nope + rope), x to a kv latent + one shared
    # rope key, the normed latent to H x (nope + v)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_dense_layers: int = 0      # dense-FFN layers ahead of the periods
    dense_d_ff: int = 0              # their FFN width (0 -> d_ff)
    # "softmax": the capacity route; "sigmoid": the dropless route
    # (sigmoid scores, bias-steered choice, weights normalised and scaled)
    router: str = "softmax"
    routed_scaling_factor: float = 1.0
    held_experts: int = 0            # routed experts held here (0 -> all)
    held_expert_start: int = 0       # the first held expert's index

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def pattern_for(self) -> Tuple[str, ...]:
        return self.block_pattern

    @property
    def num_held_experts(self) -> int:
        return self.held_experts or self.num_experts

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# the port-only fields of ``ModelConfig`` and their defaults, which leave a
# config the JAX package's (the ten ``ARCH_IDS`` configs hold them)
PORT_FIELDS = {f.name: f.default for f in dataclasses.fields(ModelConfig)
               if f.name in ("kv_lora_rank", "qk_nope_head_dim",
                             "qk_rope_head_dim", "v_head_dim",
                             "first_dense_layers", "dense_d_ff", "router",
                             "routed_scaling_factor", "held_experts",
                             "held_expert_start")}


# ---------------------------------------------------------------------------
# FL / compressor config (the paper's knobs)
# ---------------------------------------------------------------------------


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


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "seamless-m4t-medium",
    "mamba2-370m",
    "mistral-nemo-12b",
    "internvl2-1b",
    "tinyllama-1.1b",
    "qwen3-moe-30b-a3b",
    "moonshot-v1-16b-a3b",
    "llama4-scout-17b-a16e",
    "qwen1.5-0.5b",
    "recurrentgemma-2b",
]

# architectures of the port alone, with no JAX twin (outside the JAX
# mirror ``ARCH_IDS`` and its parity suites)
PORT_ARCH_IDS = [
    "moonlight-16b-a3b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def _config_module(arch_id: str):
    name = _module_name(arch_id)
    known = ARCH_IDS + PORT_ARCH_IDS
    if name not in {_module_name(a) for a in known}:
        raise ValueError(f"unknown arch {arch_id!r}; one of {known}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _config_module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _config_module(arch_id).smoke_config()


def list_archs():
    return list(ARCH_IDS)
