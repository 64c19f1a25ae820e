"""FIFO admission + prefill/decode interleaving (port of the default-
config path of the JAX package's ``serving/scheduler.py``: one class,
one tenant, unbounded queue — where the reference's priority/WFQ order
degenerates to FIFO).

When both prefill and decode work exist the scheduler strictly
alternates (one prefill chunk, one decode step, ...) so in-flight
decodes keep streaming while new prompts are absorbed; with only one
kind pending it runs that kind."""
from __future__ import annotations

import collections
from typing import Deque, Dict, List

from repro_torch.serving.request import RequestState, Status


class Scheduler:
    def __init__(self) -> None:
        self._queue: Deque[RequestState] = collections.deque()
        self.prefilling: List[RequestState] = []
        self.decoding: Dict[int, RequestState] = {}
        self._last = "decode"        # so the first contested pick prefills

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def enqueue(self, rs: RequestState) -> None:
        self._queue.append(rs)

    def has_queued(self) -> bool:
        return bool(self._queue)

    def pop_admit(self) -> RequestState:
        return self._queue.popleft()

    def has_work(self) -> bool:
        return bool(self._queue or self.prefilling or self.decoding)

    def next_action(self) -> str:
        """"prefill" | "decode" | "idle" (strict alternation when both)."""
        if not self.prefilling and not self.decoding:
            return "idle"
        if self.prefilling and (not self.decoding or self._last != "prefill"):
            self._last = "prefill"
            return "prefill"
        self._last = "decode"
        return "decode"

    def prefill_head(self) -> RequestState:
        return self.prefilling[0]

    def prefill_group(self) -> List[RequestState]:
        """All pending prefills sharing the head's prompt length (batched
        whole-prompt prefill shares one forward)."""
        head_len = self.prefilling[0].request.prompt_len
        return [rs for rs in self.prefilling
                if rs.request.prompt_len == head_len]

    def to_decode(self, rs: RequestState) -> None:
        self.prefilling.remove(rs)
        rs.status = Status.DECODE
        self.decoding[rs.slot] = rs

    def finish(self, rs: RequestState) -> None:
        self.decoding.pop(rs.slot, None)
        rs.status = Status.FINISHED
