"""moonlight-16b-a3b — DeepSeek-V3-style MoE [hf:moonshotai/Moonlight-16B-A3B].

The published model (``model_type`` deepseek_v3): 27 layers at
d_model=2048, the first dense (FFN 11264), the other 26 MoE. Attention is
multi-head latent attention with no q compression: 16 heads, q of 128
(nope) + 64 (rope) dims, a kv latent of 512 and one shared 64-dim rope
key, v of 128, RoPE θ 50,000. Each MoE layer routes over 64 experts of
width 1408 by sigmoid scores, 6 a token chosen on score + a correction
bias (``noaux_tc``, one group), the weights normalised and scaled by
2.446, no capacity; 2 shared experts. RMSNorm ε 1e-5, untied head,
vocab=163840. A port-only architecture (``PORT_ARCH_IDS``):
``moonshot_v1_16b_a3b`` is the JAX package's assignment twin, not this
shape.

``held_experts``/``held_expert_start`` give the routed experts one chip
holds under expert parallelism; ``CONFIG`` holds all 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    shared_experts=2,
    block_pattern=("mla",),
    rope_theta=50000.0,
    norm_eps=1e-5,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_dense_layers=1,
    dense_d_ff=11264,
    router="sigmoid",
    routed_scaling_factor=2.446,
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    """Small widths in f32; 4 of the 8 routed experts held (2..5)."""
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=32,
        vocab_size=256, num_experts=8, experts_per_token=3, shared_experts=1,
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, dense_d_ff=96, held_experts=4, held_expert_start=2,
        dtype="float32",
    )
