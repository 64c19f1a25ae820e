"""Sparsity execution policies for the port (``SparsityPolicy``), the
calibration capture hook, the self-contained policy artifact and the
calibrated policy ladder (``PolicyLadder``, ``calibrate_ladder``)."""
from repro_torch.sparsity.ladder import PolicyLadder, calibrate_ladder
from repro_torch.sparsity.policy import (ARTIFACT_VERSION, PHASES,
                                         VALID_BACKENDS, CaptureSink,
                                         SparsityPolicy)

__all__ = ["SparsityPolicy", "CaptureSink", "VALID_BACKENDS", "PHASES",
           "ARTIFACT_VERSION", "PolicyLadder", "calibrate_ladder"]
