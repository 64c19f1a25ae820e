"""Continuous-batching serving engine for the port: slot KV pool,
priority scheduler with per-tenant WFQ, a bounded queue, deadlines and
KV preemption, phase-aware chunked prefill and batched slot decode, each
built once per ladder rung, SLO-driven ladder serving, self-speculative
decoding (sparse rungs draft, the dense rung verifies), the radix-tree
prefix cache, and the HTTP/1.1 + SSE gateway
(``repro_torch.serving.gateway.Gateway``: ``/v1/generate``,
``/v1/health``, ``/metrics``) that owns the engine loop on a background
thread with graceful SIGTERM drain."""
from repro_torch.serving.controller import (AdaptiveController, SLOConfig,
                                            SpecController)
from repro_torch.serving.engine import (SNAPSHOT_SCHEMA_VERSION, Engine,
                                       EngineConfig)
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.graphs import (ChunkSteps, DecodeSteps, GraphSpace,
                                        VerifySteps)
from repro_torch.serving.kv_pool import SlotKVPool, SuspendedSlot
from repro_torch.serving.metrics import EngineStats, RingBuffer, percentile
from repro_torch.serving.prefix_cache import PrefixCache, RadixTree
from repro_torch.serving.request import (FinishReason, Priority, Request,
                                         RequestState, Status)
from repro_torch.serving.scheduler import (QueueFull, Scheduler,
                                           SchedulerConfig)
from repro_torch.serving.spec import SpecConfig, SpecDecoder
from repro_torch.sparsity import PolicyLadder, SparsityPolicy

__all__ = [
    "Engine", "EngineConfig", "SlotKVPool", "SuspendedSlot", "EngineStats",
    "RingBuffer", "percentile", "Request", "RequestState", "Status",
    "FinishReason", "Priority", "Scheduler", "SchedulerConfig", "QueueFull",
    "SparsityPolicy", "PolicyLadder", "AdaptiveController", "SLOConfig",
    "DecodeSteps", "ChunkSteps", "VerifySteps", "GraphSpace", "SpecConfig",
    "SpecDecoder", "SpecController", "PrefixCache", "RadixTree", "Gateway",
    "SNAPSHOT_SCHEMA_VERSION",
]
