"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2 on
every 2nd layer, Mamba:attention 7:1 interleave (attention at period index
4), ssm_state=16.  Hybrid -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

_PERIOD = (
    ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
    ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba_v01_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    layer_pattern=_PERIOD,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=0.0,  # jamba uses no positional encoding (mamba provides order)
    subquadratic=True,
)
