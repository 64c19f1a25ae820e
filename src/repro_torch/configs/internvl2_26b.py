"""internvl2-26b [vlm] — arXiv:2404.16821 (InternViT-6B + InternLM2-20B).

LM backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings for a 256-token image prefix (DESIGN.md SS5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=(("attn", "dense"),),
    rope_theta=1000000.0,
    vision_prefix=256,
)
