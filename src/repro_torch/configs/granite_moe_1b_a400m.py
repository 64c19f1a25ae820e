"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b_a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=32,
    num_experts_per_tok=8,
    layer_pattern=(("attn", "moe"),),
    tie_embeddings=True,
    rope_theta=10000.0,
)
