"""Continuous-batching serving engine core for the port: slot KV pool,
FIFO scheduler, phase-aware chunked prefill and batched slot decode."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_pool import SlotKVPool
from repro_torch.serving.metrics import EngineStats, RingBuffer, percentile
from repro_torch.serving.request import (FinishReason, Request, RequestState,
                                         Status)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.sparsity import SparsityPolicy

__all__ = [
    "Engine", "EngineConfig", "SlotKVPool", "EngineStats", "RingBuffer",
    "percentile", "Request", "RequestState", "Status", "FinishReason",
    "Scheduler", "SparsityPolicy",
]
