"""mamba2-370m — attention-free SSM, SSD (state-space duality) [arXiv:2405.21060].

48L, d_model=1024, ssm_state=128, head_dim=64 (=> 32 SSD heads at expand=2),
vocab=50280. Sub-quadratic: O(1) decode state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    conv_width=4,
    block_pattern=("ssm",),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
        vocab_size=512, dtype="float32",
    )
