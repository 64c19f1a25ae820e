"""Continuous-batching serving engine for the port: slot KV pool, FIFO
scheduler, phase-aware chunked prefill and batched slot decode, each
built once per ladder rung, SLO-driven ladder serving, and
self-speculative decoding (sparse rungs draft, the dense rung
verifies)."""
from repro_torch.serving.controller import (AdaptiveController, SLOConfig,
                                            SpecController)
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.graphs import (ChunkSteps, DecodeSteps, GraphSpace,
                                        VerifySteps)
from repro_torch.serving.kv_pool import SlotKVPool
from repro_torch.serving.metrics import EngineStats, RingBuffer, percentile
from repro_torch.serving.request import (FinishReason, Request, RequestState,
                                         Status)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.spec import SpecConfig, SpecDecoder
from repro_torch.sparsity import PolicyLadder, SparsityPolicy

__all__ = [
    "Engine", "EngineConfig", "SlotKVPool", "EngineStats", "RingBuffer",
    "percentile", "Request", "RequestState", "Status", "FinishReason",
    "Scheduler", "SparsityPolicy", "PolicyLadder", "AdaptiveController",
    "SLOConfig", "DecodeSteps", "ChunkSteps", "VerifySteps", "GraphSpace",
    "SpecConfig", "SpecDecoder", "SpecController",
]
