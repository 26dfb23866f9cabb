"""mistral-nemo-12b — dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L, d_model=5120, 32H (GQA kv=8), head_dim=128, d_ff=14336, vocab=131072.
Full attention at base; the long_500k serving variant uses the mistral-family
sliding window (8192) as a first-class ``attn_window`` flag.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, dtype="float32",
    )
