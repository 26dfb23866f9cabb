"""llama4-scout-17b-a16e — MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model=5120, 40H (GQA kv=8), per-expert d_ff=8192, 16 experts top-1
plus 1 shared expert, vocab=202048. Llama4's iRoPE chunked-local attention
(8192) is the native sub-quadratic mode used for long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    shared_experts=1,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, num_experts=4, experts_per_token=1,
        shared_experts=1, dtype="float32",
    )
