"""Fault tolerance of the port (the JAX package's ``distributed``; its
sharding names come with the sharding slice)."""
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Preemption,
                                                     RunnerConfig,
                                                     TrainingRunner)

__all__ = ["FailureInjector", "Preemption", "RunnerConfig", "TrainingRunner"]
