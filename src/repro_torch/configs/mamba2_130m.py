"""mamba2-130m [ssm] — arXiv:2405.21060 (SSD / state-space duality).

24L d_model=768 (attn-free, no FFN) vocab=50280, ssm_state=128,
expand=2 -> d_inner=1536, head_dim=64 -> 24 SSD heads.  O(1) decode state
-> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(("mamba", "none"),),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    subquadratic=True,
)
