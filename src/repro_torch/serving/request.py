"""Request lifecycle for the continuous-batching engine (port of the JAX
package's ``serving/request.py``).

A ``Request`` is the immutable submission (prompt, budget, stop rules,
priority class, tenant); ``RequestState`` is the engine-side record of
its slot, prefill cursor, generated tokens and timing.  The prompt
occupies cache positions ``[0, P)``; the i-th decode step consumes the
latest token at position ``P + i`` (the first generated token comes from
the prefill logits, not a decode step).

Priority scheduling adds three service classes (lower value = more
important) and two lifecycle states: a queued request whose queue-wait
deadline passes finishes with ``FinishReason.EXPIRED`` without ever
touching a slot, and a decoding request preempted by the scheduler moves
to ``Status.SUSPENDED``: its KV state lives in host memory
(``RequestState.suspended``) until a slot frees up and the engine
resumes it bit-identically."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, List, Optional

import numpy as np


class Priority(enum.IntEnum):
    """Service class; lower value = more important.  Admission is strict
    priority across classes; preemption only ever suspends a victim whose
    class is *strictly* less important than the arrival's."""
    INTERACTIVE = 0
    STANDARD = 1
    BEST_EFFORT = 2

    @classmethod
    def parse(cls, name: str) -> "Priority":
        try:
            return cls[str(name).strip().upper().replace("-", "_")]
        except KeyError:
            raise ValueError(
                f"unknown priority {name!r}; expected one of "
                f"{[p.name.lower() for p in cls]}") from None


class Status(enum.Enum):
    QUEUED = "queued"          # waiting for a slot
    PREFILL = "prefill"        # slot assigned, prompt being processed
    DECODE = "decode"          # generating tokens
    SUSPENDED = "suspended"    # preempted; KV state held in host memory
    FINISHED = "finished"


class FinishReason(enum.Enum):
    MAX_TOKENS = "max_tokens"
    EOS = "eos"
    EXPIRED = "expired"        # queue-wait deadline passed before admission


@dataclasses.dataclass(frozen=True)
class Request:
    request_id: int
    prompt: np.ndarray                       # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    priority: Priority = Priority.STANDARD
    tenant: str = "default"
    # admission deadline, seconds after arrival_time; None = wait forever
    queue_deadline_s: Optional[float] = None

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
    # streaming hook: called as on_token(request_id, token) per new token
    on_token: Optional[Callable[[int, int], None]] = None
    # completion hook: called as on_finish(state) exactly once, after the
    # engine's finish bookkeeping (including deadline expiry) — the
    # gateway's end-of-stream signal
    on_finish: Optional[Callable[["RequestState"], None]] = None
    # preemption bookkeeping: the host-side SuspendedSlot while suspended,
    # the clock reading of the suspension, lifetime preemption count
    suspended: Optional[Any] = None
    suspend_time: Optional[float] = None
    preemptions: int = 0

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
        if self.on_token is not None:
            self.on_token(self.request.request_id, token)

    def finished(self) -> None:
        if self.on_finish is not None:
            self.on_finish(self)
