"""granite-moe-3b-a800m [moe] — granite-3.0-3b-a800m family.

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_3b_a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_tok=8,
    layer_pattern=(("attn", "moe"),),
    tie_embeddings=True,
    rope_theta=10000.0,
)
