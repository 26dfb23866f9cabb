"""tinyllama-1.1b — dense llama2-arch small [arXiv:2401.02385].

22L, d_model=2048, 32H (GQA kv=4), head_dim=64, d_ff=5632, vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    source="arXiv:2401.02385",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, d_ff=512,
        vocab_size=512, dtype="float32",
    )
