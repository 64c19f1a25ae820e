"""gemma2-2b [dense] — arXiv:2408.00118.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, local+global
alternating (window 4096), attention+final logit softcaps, GeGLU,
head_dim=256.  Local-attention-dominant -> runs long_500k (bounded KV on
local layers; see DESIGN.md SS5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2_2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    mlp_activation="geglu",
    layer_pattern=(("local", "dense"), ("global", "dense")),
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    scale_embed=True,
    rope_theta=10000.0,
    subquadratic=True,
)
