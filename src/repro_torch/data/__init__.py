"""Synthetic token data (numpy only), the same streams as the JAX
package's ``data`` module."""
from repro_torch.data.synthetic import DataConfig, SyntheticLM, eval_batch

__all__ = ["DataConfig", "SyntheticLM", "eval_batch"]
