"""internvl2-1b — VLM: InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821].

Backbone: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151655, QKV bias
(Qwen2 family). The vision encoder + MLP projector are a stub: ``input_specs``
supplies projected patch embeddings (B, 256, 896).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    modality="vision",
    num_mm_tokens=256,
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=112, num_heads=7, num_kv_heads=1, d_ff=256,
        vocab_size=512, num_mm_tokens=4, dtype="float32",
    )
