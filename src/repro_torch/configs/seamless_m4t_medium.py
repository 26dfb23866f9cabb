"""seamless-m4t-medium — enc-dec multimodal (audio) [arXiv:2308.11596].

12L encoder + 12L decoder, d_model=1024, 16H (GQA kv=16 = MHA), d_ff=4096,
vocab=256206. The speech frontend (mel + conv feature extractor) is a stub:
``input_specs`` supplies precomputed frame embeddings (B, T_frames, 1024).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,             # decoder
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    modality="audio",
    num_mm_tokens=512,         # stub audio frames per example (train/prefill)
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, enc_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, num_mm_tokens=8, dtype="float32",
    )
