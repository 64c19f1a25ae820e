"""Engine statistics (port of the core of the JAX package's
``serving/metrics.py``): per-phase step counts and latencies, throughput,
queue depth and slot occupancy, TTFT and the inter-token (TPOT) gaps,
the speculative-decoding counters and per-round series, the prefix-cache
counters, and the admission-control and preemption counters.

Per-sample series are fixed-capacity :class:`RingBuffer`s keeping exact
whole-run count and sum; :func:`percentile` gives exact nearest-rank
values over a ring's window (the whole run until it holds ``capacity``
samples).  The reference backs its SLO-facing percentiles (TPOT, TTFT,
queue wait, preempted time) with whole-run bucketed histograms, which
come with the gateway slice, where the Prometheus exposition needs
them; until then :meth:`EngineStats.summary` takes every p50/p95,
queue wait and preempted time included, from the rings."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable


class RingBuffer:
    """Append-only numeric series keeping the last ``capacity`` samples
    plus exact whole-run ``count``/``total`` aggregates."""

    __slots__ = ("capacity", "_buf", "_start", "count", "total")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._buf = []
        self._start = 0
        self.count = 0
        self.total = 0.0

    def append(self, v) -> None:
        v = float(v)
        if len(self._buf) < self.capacity:
            self._buf.append(v)
        else:
            self._buf[self._start] = v
            self._start = (self._start + 1) % self.capacity
        self.count += 1
        self.total += v

    def __iter__(self):
        n = len(self._buf)
        for i in range(n):
            yield self._buf[(self._start + i) % n]

    def __bool__(self) -> bool:
        return bool(self._buf)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def percentile(values: Iterable[float], p: float) -> float:
    """Nearest-rank percentile (no interpolation)."""
    vs = sorted(values)
    if not vs:
        return float("nan")
    k = max(0, min(len(vs) - 1, int(round(p / 100.0 * (len(vs) - 1)))))
    return vs[k]


@dataclasses.dataclass
class EngineStats:
    submitted: int = 0
    finished: int = 0
    prefill_chunks: int = 0
    prefill_sparse_chunks: int = 0           # chunks under the sparse phase
    prefill_tokens: int = 0                  # real (non-pad) prompt tokens
    decode_steps: int = 0
    decode_tokens: int = 0                   # generated tokens (incl. first)
    prefill_time: float = 0.0                # seconds in prefill steps
    decode_time: float = 0.0                 # seconds in decode steps
    queue_depth: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    occupancy: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    decode_step_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    prefill_step_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    tpot_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    ttft_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    # --- speculative decoding -------------------------------------------
    spec_rounds: int = 0                     # spec rounds (draft + verify)
    spec_draft_steps: int = 0                # single-token drafter steps
    spec_verifies: int = 0                   # per-slot verify outcomes
    spec_draft_tokens: int = 0               # drafted tokens (gamma/slot)
    spec_accepted_tokens: int = 0            # drafts surviving verification
    spec_committed_tokens: int = 0           # emitted by spec (incl. bonus)
    # per-round phase latencies: one draft sample covers the round's gamma
    # sequential drafter steps, one verify sample the batched verify
    spec_draft_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    spec_verify_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    # per-slot per-round accepted-draft counts (the acceptance series; the
    # whole-run rate comes from the exact counters above)
    spec_accepted_per_verify: RingBuffer = dataclasses.field(
        default_factory=RingBuffer)
    # --- prefix caching --------------------------------------------------
    prefix_lookups: int = 0                  # admissions that consulted it
    prefix_hits: int = 0                     # admissions that reused KV
    prefix_tokens_saved: int = 0             # prompt tokens not prefilled
    prefix_evicted_segments: int = 0         # segments dropped by LRU
    # matched prefix length per hit (the reuse-depth series)
    prefix_hit_len: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    # --- admission control + preemption ----------------------------------
    preemptions: int = 0                     # decoding requests suspended
    resumes: int = 0                         # suspended requests restored
    rejected: int = 0                        # submissions refused (queue full)
    expired: int = 0                         # queue-wait deadline passed
    # seconds a request spent queued before admission / suspended before
    # its resume
    queue_wait_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    preempted_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)

    def sample(self, queue_depth: int, occupied_slots: int) -> None:
        self.queue_depth.append(queue_depth)
        self.occupancy.append(occupied_slots)

    def observe_queue_wait(self, v: float) -> None:
        self.queue_wait_s.append(v)

    def observe_preempted(self, v: float) -> None:
        self.preempted_s.append(v)

    @property
    def decode_tps(self) -> float:
        return self.decode_tokens / self.decode_time if self.decode_time else 0.0

    @property
    def prefill_tps(self) -> float:
        return (self.prefill_tokens / self.prefill_time
                if self.prefill_time else 0.0)

    def summary(self) -> Dict[str, float]:
        """Whole-run counters plus exact nearest-rank p50/p95 of the
        per-step latencies, TTFT, TPOT, queue wait and preempted time
        over the retained window (the whole run while it holds fewer than
        ``capacity`` samples)."""
        out = {
            "submitted": self.submitted,
            "finished": self.finished,
            "prefill_chunks": self.prefill_chunks,
            "prefill_sparse_chunks": self.prefill_sparse_chunks,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "prefill_time_s": self.prefill_time,
            "decode_time_s": self.decode_time,
            "prefill_tps": self.prefill_tps,
            "decode_tps": self.decode_tps,
            "mean_occupancy": self.occupancy.mean,
            "mean_queue_depth": self.queue_depth.mean,
        }
        for name, ring in (("decode_step", self.decode_step_s),
                           ("prefill_step", self.prefill_step_s),
                           ("ttft", self.ttft_s), ("tpot", self.tpot_s)):
            if ring:
                out[f"{name}_p50_s"] = percentile(ring, 50)
                out[f"{name}_p95_s"] = percentile(ring, 95)
        if self.spec_rounds:
            out["spec_rounds"] = self.spec_rounds
            out["spec_committed_tokens"] = self.spec_committed_tokens
            out["spec_accept_rate"] = (self.spec_accepted_tokens
                                       / max(1, self.spec_draft_tokens))
            out["spec_accepted_per_verify"] = (self.spec_accepted_tokens
                                               / max(1, self.spec_verifies))
            ring = self.spec_accepted_per_verify
            if ring:
                out["spec_accepted_per_verify_p50"] = percentile(ring, 50)
                out["spec_accepted_per_verify_p95"] = percentile(ring, 95)
            for name, ring in (("spec_draft", self.spec_draft_s),
                               ("spec_verify", self.spec_verify_s)):
                if ring:
                    out[f"{name}_p50_s"] = percentile(ring, 50)
                    out[f"{name}_p95_s"] = percentile(ring, 95)
        if self.prefix_lookups:
            out["prefix_hit_rate"] = self.prefix_hits / self.prefix_lookups
            out["prefix_tokens_saved"] = self.prefix_tokens_saved
            if self.prefix_hit_len:
                out["prefix_hit_len_p50"] = percentile(self.prefix_hit_len,
                                                       50)
        if self.queue_wait_s:
            out["queue_wait_p50_s"] = percentile(self.queue_wait_s, 50)
            out["queue_wait_p95_s"] = percentile(self.queue_wait_s, 95)
        if self.rejected or self.expired:
            out["rejected"] = self.rejected
            out["expired"] = self.expired
        if self.preemptions:
            out["preemptions"] = self.preemptions
            out["resumes"] = self.resumes
            if self.preempted_s:
                out["preempted_p50_s"] = percentile(self.preempted_s, 50)
                out["preempted_p95_s"] = percentile(self.preempted_s, 95)
        return out
