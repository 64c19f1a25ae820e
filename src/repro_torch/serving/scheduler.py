"""Priority admission + prefill/decode interleaving policy (port of the
JAX package's ``serving/scheduler.py``; plain Python, copied).

Admission moves queued requests into free pool slots in *priority order*:
strict priority across the three service classes (``Priority``), and
weighted fair queuing across tenants inside a class — each tenant's
requests are stamped with a virtual start time advanced by
``(prompt_len + max_new_tokens) / weight`` per request, and the class
serves whichever tenant's head carries the smallest stamp, so a tenant
with weight 2 drains twice as fast as a weight-1 tenant under contention
while an idle tenant's backlog never starves.  With a default config
(single class, single tenant) this is exactly FIFO order.

The scheduler also owns the admission-control state: a bounded queue
(``can_accept``), per-request queue-wait deadlines (``expire`` sweeps the
queue before each admission pass), and the preemption bookkeeping —
``pick_victim`` selects the least important, youngest decoding request
to suspend and ``suspended`` holds preempted requests (KV state in host
memory) until ``peek_resume``/``pop_resume`` bring the most important,
longest-waiting one back.  The engine moves the KV state; the scheduler
only decides who.

When both prefill and decode work exist the scheduler strictly
alternates (one prefill chunk, one decode step, ...) so in-flight
decodes keep streaming while new prompts are absorbed — the
continuous-batching property.  With only one kind of work pending it
runs that kind."""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.request import Priority, RequestState, Status


class QueueFull(RuntimeError):
    """Admission queue is at capacity.  ``retry_after`` is the engine's
    estimate (seconds, >= 1) of when capacity frees up."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission policy knobs (hashable, like the engine/SLO configs).

    ``max_queue``: bounded admission queue; 0 = unbounded (no
    backpressure).  ``preemption``: allow suspending a strictly less
    important decoding request to admit a more important arrival.
    ``tenant_weights``: ((tenant, weight), ...) WFQ shares; unlisted
    tenants get weight 1.0."""
    max_queue: int = 0
    preemption: bool = False
    tenant_weights: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.max_queue < 0:
            raise ValueError(f"max_queue {self.max_queue} must be >= 0")
        weights = dict(self.tenant_weights)
        for tenant, w in weights.items():
            if not w > 0:
                raise ValueError(
                    f"tenant {tenant!r} weight {w} must be positive")
        object.__setattr__(self, "_weights", weights)

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)


class Scheduler:
    def __init__(self, cfg: Optional[SchedulerConfig] = None) -> None:
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        # per-class, per-tenant FIFO deques of (vstart, seq, rs); heads
        # carry each tenant's smallest stamp because stamps are assigned
        # monotonically per tenant
        self._queues: Dict[Priority, Dict[str, Deque]] = {
            p: {} for p in Priority}
        self._vtime: Dict[Priority, Dict[str, float]] = {
            p: {} for p in Priority}
        self._vclock: Dict[Priority, float] = {p: 0.0 for p in Priority}
        self._seq = 0                # global FIFO tie-break
        self._depth = 0
        self.prefilling: List[RequestState] = []
        self.decoding: Dict[int, RequestState] = {}
        self.suspended: List[RequestState] = []   # append order = suspend order
        self._last = "decode"        # so the first contested pick prefills

    # ---- admission queue -------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self._depth

    def has_queued(self) -> bool:
        return self._depth > 0

    def can_accept(self) -> bool:
        return self.cfg.max_queue == 0 or self._depth < self.cfg.max_queue

    def enqueue(self, rs: RequestState) -> None:
        if not self.can_accept():
            raise QueueFull(
                f"admission queue at capacity ({self.cfg.max_queue})")
        req = rs.request
        p, tenant = req.priority, req.tenant
        start = max(self._vtime[p].get(tenant, 0.0), self._vclock[p])
        cost = (req.prompt_len + req.max_new_tokens) / self.cfg.weight(tenant)
        self._vtime[p][tenant] = start + cost
        self._queues[p].setdefault(tenant, collections.deque()).append(
            (start, self._seq, rs))
        self._seq += 1
        self._depth += 1

    def queued(self) -> List[RequestState]:
        """Every queued request, most important class first (order within
        a class is unspecified — for expiry sweeps and introspection, not
        admission: ``pop_admit`` owns the WFQ order)."""
        out = []
        for p in Priority:
            for dq in self._queues[p].values():
                out.extend(rs for _, _, rs in dq)
        return out

    def expire(self, now: float) -> List[RequestState]:
        """Remove and return queued requests whose queue-wait deadline
        (``arrival_time + queue_deadline_s``) has passed.  The engine
        finishes them with ``FinishReason.EXPIRED``."""
        expired: List[RequestState] = []
        for p in Priority:
            for tenant, dq in self._queues[p].items():
                kept = collections.deque()
                for entry in dq:
                    rs = entry[2]
                    dl = rs.request.queue_deadline_s
                    if dl is not None and now - rs.request.arrival_time > dl:
                        expired.append(rs)
                        self._depth -= 1
                    else:
                        kept.append(entry)
                self._queues[p][tenant] = kept
        return expired

    def head_priority(self) -> Optional[Priority]:
        """Class of the request ``pop_admit`` would return, or None."""
        for p in Priority:
            if any(self._queues[p].values()):
                return p
        return None

    def pop_admit(self) -> RequestState:
        """Pop the next request in admission order: most important
        non-empty class, then the tenant whose head carries the smallest
        WFQ stamp (FIFO seq breaks ties)."""
        for p in Priority:
            heads = [(dq[0], tenant)
                     for tenant, dq in self._queues[p].items() if dq]
            if not heads:
                continue
            (start, _seq, rs), tenant = min(heads)
            self._queues[p][tenant].popleft()
            self._vclock[p] = max(self._vclock[p], start)
            self._depth -= 1
            return rs
        raise IndexError("pop_admit: admission queue is empty")

    # ---- preemption ------------------------------------------------------
    def pick_victim(self, priority: Priority) -> Optional[RequestState]:
        """The decoding request to suspend so a ``priority``-class
        arrival can run: the least important, then youngest, decoding
        request whose class is *strictly* less important — or None (no
        eligible victim means no preemption, never a same-class swap)."""
        victims = [rs for rs in self.decoding.values()
                   if rs.request.priority > priority]
        if not victims:
            return None
        return max(victims, key=lambda rs: (
            rs.request.priority, rs.request.arrival_time,
            rs.request.request_id))

    def suspend(self, rs: RequestState) -> None:
        """Move a decoding request to the suspended set (the engine has
        already copied its KV state out and will free the slot)."""
        popped = self.decoding.pop(rs.slot, None)
        if popped is not rs:
            raise ValueError(
                f"suspend: request {rs.request.request_id} is not decoding "
                f"in slot {rs.slot}")
        rs.status = Status.SUSPENDED
        self.suspended.append(rs)

    def peek_resume(self) -> Optional[RequestState]:
        """The suspended request next in line for a slot: most important
        class first, earliest suspension within a class."""
        if not self.suspended:
            return None
        return min(enumerate(self.suspended),
                   key=lambda e: (e[1].request.priority, e[0]))[1]

    def pop_resume(self) -> RequestState:
        rs = self.peek_resume()
        if rs is None:
            raise IndexError("pop_resume: no suspended requests")
        self.suspended.remove(rs)
        return rs

    # ---- prefill/decode interleaving ------------------------------------
    def has_work(self) -> bool:
        return bool(self._depth or self.prefilling or self.decoding
                    or self.suspended)

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
