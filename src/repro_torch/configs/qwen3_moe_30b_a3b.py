"""qwen3-moe-30b-a3b — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32H (GQA kv=4), head_dim=128, per-expert d_ff=768,
128 experts top-8, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=512, num_experts=4, experts_per_token=2,
        dtype="float32",
    )
