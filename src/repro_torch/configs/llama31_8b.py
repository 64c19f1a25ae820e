"""llama3.1-8b — the paper's primary evaluation model (arXiv:2407.21783).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope theta 500k.
Used by benchmarks/examples; not one of the 10 assigned dry-run archs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama31_8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=(("attn", "dense"),),
    rope_theta=500000.0,
)
