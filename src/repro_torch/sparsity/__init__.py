"""Sparsity execution policies for the port (``SparsityPolicy``), the
calibration capture hook and the self-contained policy artifact."""
from repro_torch.sparsity.policy import (ARTIFACT_VERSION, PHASES,
                                         VALID_BACKENDS, CaptureSink,
                                         SparsityPolicy)

__all__ = ["SparsityPolicy", "CaptureSink", "VALID_BACKENDS", "PHASES",
           "ARTIFACT_VERSION"]
