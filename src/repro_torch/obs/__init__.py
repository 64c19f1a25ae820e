"""Observability for the port: the serving clock."""
from repro_torch.obs.clock import now

__all__ = ["now"]
