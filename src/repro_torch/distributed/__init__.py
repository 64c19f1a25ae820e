"""Multi-rank layer of the port (the JAX package's ``distributed``): the
logical-axis sharding rules over a ``torch.distributed`` device mesh, and
fault tolerance."""
from repro_torch.distributed.sharding import (LOGICAL_RULES_SERVE,
                                              LOGICAL_RULES_TRAIN,
                                              NamedSharding, ShardingCtx,
                                              constrain, current_ctx,
                                              distribute, local_call,
                                              mesh_axes_for, named_sharding,
                                              param_shardings, placements,
                                              sharding_context)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Preemption,
                                                     RunnerConfig,
                                                     TrainingRunner)

__all__ = [
    "LOGICAL_RULES_SERVE", "LOGICAL_RULES_TRAIN", "NamedSharding",
    "ShardingCtx", "constrain", "current_ctx", "distribute", "local_call",
    "mesh_axes_for", "named_sharding", "param_shardings", "placements",
    "sharding_context",
    "FailureInjector", "Preemption", "RunnerConfig", "TrainingRunner",
]
