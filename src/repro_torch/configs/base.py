"""Model/shape configuration dataclasses and the architecture registry.

A plain-data copy of the JAX package's ``configs/base.py`` (the port
imports nothing from that package).  Every architecture gets its own
module in ``repro_torch.configs`` exporting ``CONFIG``.
``get_config(name)`` resolves them; ``reduced(cfg)`` produces a tiny
same-family config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


# Layer "kinds": (mixer, ffn).  mixer in {"attn", "local", "global", "mamba",
# "attn_bidir"}; ffn in {"dense", "moe", "none"}.
LayerKind = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MLP ---
    mlp_activation: str = "swiglu"   # swiglu | geglu
    # --- attention ---
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0       # final-logit softcap (gemma2)
    attn_softcap: float = 0.0        # attention-logit softcap (gemma2)
    sliding_window: int = 0          # window for "local" layers (0 = unused)
    layer_pattern: Tuple[LayerKind, ...] = (("attn", "dense"),)
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / jamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256             # SSD chunk length
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 0          # precomputed conv-frontend frames (stub input)
    # --- VLM (internvl) ---
    vision_prefix: int = 0           # precomputed patch-embedding prefix length
    # --- misc ---
    scale_embed: bool = False        # gemma-family sqrt(d_model) embed scale
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    max_position: int = 1 << 20
    # Does the arch support O(1)-memory-per-token decode at 500k context?
    # (SSM / hybrid / mostly-local-attention archs).  Pure full-attention
    # archs skip the long_500k cell (see DESIGN.md SS5).
    subquadratic: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def num_experts_padded(self) -> int:
        """Experts padded up to the TP width (16) so the expert dim always
        shards (granite-3b: 40 -> 48).  Pad experts get -inf router logits
        and are never selected — numerics match the unpadded model
        (EXPERIMENTS.md SSPerf iteration C3)."""
        e = self.num_experts
        if e > 16 and e % 16:
            return ((e + 15) // 16) * 16
        return e

    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """Expanded per-layer (mixer, ffn) kinds for all num_layers layers."""
        p = self.layer_pattern
        reps = (self.num_layers + len(p) - 1) // len(p)
        return tuple((p * reps)[: self.num_layers])

    def layer_groups(self):
        """[(pattern, repeats)] chunks: a scan over `repeats` periods of
        `pattern`, plus a possibly-shorter trailing group."""
        p = self.layer_pattern
        full, rem = divmod(self.num_layers, len(p))
        groups = []
        if full:
            groups.append((p, full))
        if rem:
            groups.append((p[:rem], 1))
        return groups


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "granite_moe_1b_a400m",
    "granite_moe_3b_a800m",
    "internvl2_26b",
    "deepseek_67b",
    "gemma2_2b",
    "gemma_2b",
    "gemma3_4b",
    "mamba2_130m",
    "whisper_large_v3",
    "jamba_v01_52b",
    # the paper's own model, used by benchmarks/examples
    "llama31_8b",
]


def get_config(name: str) -> ModelConfig:
    mod_name = name.replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def runnable_cells():
    """All (arch, shape) cells that the dry-run must lower, with skips
    applied per DESIGN.md SS5 (long_500k only for subquadratic archs)."""
    cells, skips = [], []
    for arch in ARCH_IDS:
        if arch == "llama31_8b":
            continue  # paper's model is extra, not an assigned cell
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                skips.append((arch, shape.name, "full-attention KV at 524k"))
                continue
            cells.append((arch, shape.name))
    return cells, skips


def reduced(cfg: ModelConfig, seq_hint: int = 64) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        num_layers=max(2, len(cfg.layer_pattern)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        moe_d_ff=64 if cfg.num_experts else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, seq_hint // 2) if cfg.sliding_window else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_frames=16 if cfg.encoder_frames else 0,
        vision_prefix=8 if cfg.vision_prefix else 0,
        max_position=4096,
        dtype="float32",
    )
