"""whisper-large-v3 [audio] — arXiv:2212.04356.

Enc-dec, 32+32L d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866.
The conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (1500 frames = 30 s).  Shapes' ``seq_len`` applies to the
decoder (DESIGN.md SS5).  Full attention decoder -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_large_v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_activation="gelu",
    layer_pattern=(("attn", "dense"),),
    encoder_layers=32,
    encoder_frames=1500,
    rope_theta=0.0,  # whisper uses learned/sinusoidal absolute positions
)
