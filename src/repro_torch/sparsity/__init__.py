"""Sparsity execution policies for the port (``SparsityPolicy``)."""
from repro_torch.sparsity.policy import PHASES, VALID_BACKENDS, SparsityPolicy

__all__ = ["SparsityPolicy", "VALID_BACKENDS", "PHASES"]
