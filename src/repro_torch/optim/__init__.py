"""Optimizers of the port (the JAX package's ``optim``)."""
from repro_torch.optim import adamw

__all__ = ["adamw"]
