"""Observability for the port: the serving clock, and the quality
baselines' helpers (``repro_torch.obs.quality``)."""
from repro_torch.obs.clock import now

__all__ = ["now"]
