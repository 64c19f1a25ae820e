"""gemma-2b [dense] — arXiv:2403.08295.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU, head_dim=256.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma_2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_activation="geglu",
    layer_pattern=(("attn", "dense"),),
    tie_embeddings=True,
    scale_embed=True,
    rope_theta=10000.0,
)
