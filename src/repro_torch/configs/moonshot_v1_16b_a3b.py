"""moonshot-v1-16b-a3b — Moonlight-style MoE [hf:moonshotai/Moonlight-16B-A3B].

The JAX package's assignment twin, mirrored field for field: 48 MHA layers
(d_model=2048, 16H, kv=16), per-expert d_ff=1408, 64 experts top-6 plus 2
shared experts behind a softmax router with capacity, vocab=163840. It is
not the published shape; the published model (27 layers, latent
attention, a sigmoid-routed dropless expert layer) is
``moonlight_16b_a3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    shared_experts=2,
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=512, num_experts=4, experts_per_token=2, shared_experts=1,
        dtype="float32",
    )
