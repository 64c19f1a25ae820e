"""gemma3-4b [dense] — hf:google/gemma-3-4b-pt (unverified tier).

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, 5:1 local:global
(window 1024), head_dim=256, 128k context.  Mostly-local attention ->
runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    mlp_activation="geglu",
    layer_pattern=(
        ("local", "dense"), ("local", "dense"), ("local", "dense"),
        ("local", "dense"), ("local", "dense"), ("global", "dense"),
    ),
    sliding_window=1024,
    tie_embeddings=True,
    scale_embed=True,
    rope_theta=1000000.0,
    subquadratic=True,
)
