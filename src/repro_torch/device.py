"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and refuse to carry on when no
card is present: a caller that wants the CPU (the tests) says so with
``device="cpu"``.  Nothing falls back silently.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
