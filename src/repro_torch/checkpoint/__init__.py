"""Atomic, keep-k, async checkpoints on the JAX package's format."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
