"""Request lifecycle for the continuous-batching engine (port of the JAX
package's ``serving/request.py``; priority classes, tenants and
preemption state come with the scheduler slice).

A ``Request`` is the immutable submission; ``RequestState`` is the
engine-side record of its slot, prefill cursor, generated tokens and
timing.  The prompt occupies cache positions ``[0, P)``; the i-th decode
step consumes the latest token at position ``P + i`` (the first
generated token comes from the prefill logits, not a decode step)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class Status(enum.Enum):
    QUEUED = "queued"          # waiting for a slot
    PREFILL = "prefill"        # slot assigned, prompt being processed
    DECODE = "decode"          # generating tokens
    FINISHED = "finished"


class FinishReason(enum.Enum):
    MAX_TOKENS = "max_tokens"
    EOS = "eos"


@dataclasses.dataclass(frozen=True)
class Request:
    request_id: int
    prompt: np.ndarray                       # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_time: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class RequestState:
    request: Request
    status: Status = Status.QUEUED
    slot: int = -1
    next_offset: int = 0                     # chunked-prefill cursor
    tokens: List[int] = dataclasses.field(default_factory=list)
    last_token: int = -1
    finish_reason: Optional[FinishReason] = None
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None   # previous emit (TPOT)
    finish_time: Optional[float] = None
    # ladder serving: rung index active when each token was emitted
    # (parallel to ``tokens``; stays empty on fixed-policy engines)
    token_rungs: List[int] = dataclasses.field(default_factory=list)

    @property
    def position(self) -> int:
        """Cache position the next decode step writes (= current length)."""
        return self.request.prompt_len + len(self.tokens) - 1

    @property
    def done_prefill(self) -> bool:
        return self.next_offset >= self.request.prompt_len

    def emit(self, token: int) -> None:
        self.tokens.append(token)
        self.last_token = token
