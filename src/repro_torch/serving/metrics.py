"""Engine statistics (port of the JAX package's ``serving/metrics.py``):
per-phase step counts and latencies, throughput, queue depth and slot
occupancy, request-latency percentiles, and the decode inter-token
(TPOT) signal the adaptive controller steers on.

Every per-sample series is a fixed-capacity :class:`RingBuffer` that
keeps the most recent window while tracking the *whole-run* count and
sum, so the summary means are exact at any run length.

Percentile semantics (two estimators, deliberately, as in the
reference):

* The SLO-facing ``*_p50_s``/``*_p95_s`` summary fields come from exact
  whole-run :class:`repro_torch.obs.metrics.Histogram` instances (fixed
  log-spaced buckets, observed next to each ring append through the
  ``observe_*`` helpers): nearest-rank at bucket resolution, reporting
  the bucket's upper bound.  A ring percentile silently becomes a
  windowed estimate once ``count > capacity``; the histogram never
  drops a sample.
* ``tpot_p95_window_s`` keeps the recent-window (last ``capacity``
  samples) ring estimate, for operators who want "now" rather than
  "whole run".

:meth:`EngineStats.summary` gives the reference's keys and values
(rounded as it rounds).  The histograms are also what
:func:`repro_torch.obs.metrics.engine_registry` exports.  Exact values
(no bucket rounding) stay readable from the rings through
:func:`percentile`; the port keeps one ring the reference lacks,
``ttft_s``, and the counter ``prefill_sparse_chunks``, for callers that
want them (``summary()`` reports neither)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.obs.metrics import Histogram

# draft-length accept counts are small ints; unit-width bins make the
# accepted-per-verify histogram exact, not just bucket-resolved
_ACCEPT_BUCKETS = tuple(float(i) for i in range(17))


class RingBuffer:
    """Append-only numeric series keeping the last ``capacity`` samples
    plus exact whole-run ``count``/``total`` aggregates.

    Iteration yields the retained window in insertion order; for runs
    shorter than the capacity that is the full series."""

    __slots__ = ("capacity", "_buf", "_start", "count", "total")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._buf = []
        self._start = 0          # index of the oldest retained sample
        self.count = 0           # whole-run samples seen
        self.total = 0.0         # whole-run sum

    def append(self, v) -> None:
        v = float(v)
        if len(self._buf) < self.capacity:
            self._buf.append(v)
        else:
            self._buf[self._start] = v
            self._start = (self._start + 1) % self.capacity
        self.count += 1
        self.total += v

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        n = len(self._buf)
        for i in range(n):
            yield self._buf[(self._start + i) % n]

    def __bool__(self) -> bool:
        return bool(self._buf)

    @property
    def mean(self) -> float:
        """Whole-run mean (exact, not windowed)."""
        return self.total / self.count if self.count else 0.0

    @property
    def last(self) -> Optional[float]:
        if not self._buf:
            return None
        return self._buf[(self._start - 1) % len(self._buf)]


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
    # per-phase step latencies (seconds per step)
    decode_step_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    prefill_step_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    # per-request inter-token gaps (the true TPOT signal: it includes
    # interleaved prefill work)
    tpot_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    # arrival to first token, exact (the reference keeps only the
    # histogram)
    ttft_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    # exact whole-run histograms backing the SLO-facing percentiles
    tpot_hist: Histogram = dataclasses.field(default_factory=Histogram)
    ttft_hist: Histogram = dataclasses.field(default_factory=Histogram)
    decode_step_hist: Histogram = dataclasses.field(default_factory=Histogram)
    prefill_step_hist: Histogram = dataclasses.field(
        default_factory=Histogram)
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
    spec_draft_hist: Histogram = dataclasses.field(default_factory=Histogram)
    spec_verify_hist: Histogram = dataclasses.field(default_factory=Histogram)
    # per-slot per-round accepted-draft counts (the acceptance series; the
    # whole-run rate comes from the exact counters above)
    spec_accepted_per_verify: RingBuffer = dataclasses.field(
        default_factory=RingBuffer)
    spec_accepted_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(_ACCEPT_BUCKETS))
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
    # its resume (ring window + exact whole-run histogram, like TPOT)
    queue_wait_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    queue_wait_hist: Histogram = dataclasses.field(default_factory=Histogram)
    preempted_s: RingBuffer = dataclasses.field(default_factory=RingBuffer)
    preempted_hist: Histogram = dataclasses.field(default_factory=Histogram)

    def sample(self, queue_depth: int, occupied_slots: int) -> None:
        self.queue_depth.append(queue_depth)
        self.occupancy.append(occupied_slots)

    # -- paired ring + exact-histogram observation -----------------------
    def observe_tpot(self, v: float) -> None:
        self.tpot_s.append(v)
        self.tpot_hist.observe(v)

    def observe_ttft(self, v: float) -> None:
        self.ttft_s.append(v)
        self.ttft_hist.observe(v)

    def observe_decode_step(self, v: float) -> None:
        self.decode_step_s.append(v)
        self.decode_step_hist.observe(v)

    def observe_prefill_step(self, v: float) -> None:
        self.prefill_step_s.append(v)
        self.prefill_step_hist.observe(v)

    def observe_spec_draft(self, v: float) -> None:
        self.spec_draft_s.append(v)
        self.spec_draft_hist.observe(v)

    def observe_spec_verify(self, v: float) -> None:
        self.spec_verify_s.append(v)
        self.spec_verify_hist.observe(v)

    def observe_spec_accepted(self, n: int) -> None:
        self.spec_accepted_per_verify.append(n)
        self.spec_accepted_hist.observe(n)

    def observe_queue_wait(self, v: float) -> None:
        self.queue_wait_s.append(v)
        self.queue_wait_hist.observe(v)

    def observe_preempted(self, v: float) -> None:
        self.preempted_s.append(v)
        self.preempted_hist.observe(v)

    @property
    def decode_tps(self) -> float:
        return self.decode_tokens / self.decode_time if self.decode_time else 0.0

    @property
    def prefill_tps(self) -> float:
        return (self.prefill_tokens / self.prefill_time
                if self.prefill_time else 0.0)

    def window_tpot_p95(self) -> float:
        """Recent-window (last ``capacity`` samples) TPOT p95 — the
        "now" estimate, vs the whole-run histogram quantile."""
        return percentile(self.tpot_s, 95)

    def tpot_percentile(self, p: float) -> float:
        """Whole-run TPOT percentile from the exact histogram (bucket
        resolution, O(buckets))."""
        return self.tpot_hist.quantile(p)

    def summary(self) -> Dict[str, float]:
        """The reference's summary: whole-run counters, rounded rates,
        and p50/p95 from the whole-run histograms (bucket upper
        bounds)."""
        out = {
            "submitted": self.submitted,
            "finished": self.finished,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "prefill_time_s": round(self.prefill_time, 4),
            "decode_time_s": round(self.decode_time, 4),
            "prefill_tps": round(self.prefill_tps, 1),
            "decode_tps": round(self.decode_tps, 1),
            "mean_occupancy": round(self.occupancy.mean, 2),
            "mean_queue_depth": round(self.queue_depth.mean, 2),
        }
        if self.tpot_hist:
            # whole-run histogram percentiles; *_window_s is the
            # recent-window (last `capacity` samples) ring estimate
            out["tpot_p50_s"] = round(self.tpot_hist.quantile(50), 5)
            out["tpot_p95_s"] = round(self.tpot_hist.quantile(95), 5)
            out["tpot_p95_window_s"] = round(percentile(self.tpot_s, 95), 5)
        if self.ttft_hist:
            out["ttft_p50_s"] = round(self.ttft_hist.quantile(50), 5)
            out["ttft_p95_s"] = round(self.ttft_hist.quantile(95), 5)
        if self.spec_rounds:
            out["spec_rounds"] = self.spec_rounds
            out["spec_committed_tokens"] = self.spec_committed_tokens
            out["spec_accept_rate"] = round(
                self.spec_accepted_tokens / max(1, self.spec_draft_tokens), 4)
            out["spec_accepted_per_verify"] = round(
                self.spec_accepted_tokens / max(1, self.spec_verifies), 3)
            if self.spec_accepted_hist:
                out["spec_accepted_per_verify_p50"] = \
                    self.spec_accepted_hist.quantile(50)
                out["spec_accepted_per_verify_p95"] = \
                    self.spec_accepted_hist.quantile(95)
            for name, hist in (("spec_draft", self.spec_draft_hist),
                               ("spec_verify", self.spec_verify_hist)):
                if hist:
                    out[f"{name}_p50_s"] = round(hist.quantile(50), 5)
                    out[f"{name}_p95_s"] = round(hist.quantile(95), 5)
        if self.prefix_lookups:
            out["prefix_hit_rate"] = round(
                self.prefix_hits / self.prefix_lookups, 4)
            out["prefix_tokens_saved"] = self.prefix_tokens_saved
            if self.prefix_hit_len:
                out["prefix_hit_len_p50"] = percentile(self.prefix_hit_len, 50)
        if self.queue_wait_hist:
            out["queue_wait_p50_s"] = round(self.queue_wait_hist.quantile(50), 5)
            out["queue_wait_p95_s"] = round(self.queue_wait_hist.quantile(95), 5)
        if self.rejected or self.expired:
            out["rejected"] = self.rejected
            out["expired"] = self.expired
        if self.preemptions:
            out["preemptions"] = self.preemptions
            out["resumes"] = self.resumes
            if self.preempted_hist:
                out["preempted_p50_s"] = round(
                    self.preempted_hist.quantile(50), 5)
                out["preempted_p95_s"] = round(
                    self.preempted_hist.quantile(95), 5)
        return out


def latency_percentiles(states: Iterable, ps=(50, 95)
                        ) -> Dict[str, Optional[float]]:
    """Request latency (finish - arrival) and TTFT percentiles, seconds,
    over :class:`~repro_torch.serving.request.RequestState` records."""
    lat, ttft = [], []
    for rs in states:
        if rs.finish_time is not None:
            lat.append(rs.finish_time - rs.request.arrival_time)
        if rs.first_token_time is not None:
            ttft.append(rs.first_token_time - rs.request.arrival_time)
    out: Dict[str, Optional[float]] = {}
    for p in ps:
        out[f"latency_p{p}"] = percentile(lat, p) if lat else None
        out[f"ttft_p{p}"] = percentile(ttft, p) if ttft else None
    return out
