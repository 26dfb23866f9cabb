"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention 1:2
[arXiv:2402.19427].

26L (pattern rec,rec,attn -> 8 periods + 2-block tail), d_model=2560,
10H (MQA kv=1), head_dim=256, d_ff=7680, vocab=256000, local attention
window 2048, recurrent width 2560. Sub-quadratic: native long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=2560,
    attn_window=2048,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, rnn_width=128, attn_window=16,
        dtype="float32",
    )
