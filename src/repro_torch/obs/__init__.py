"""``repro_torch.obs`` — engine telemetry that costs nothing when off
(port of the JAX package's ``obs``).

Six surfaces behind one :class:`Telemetry` facade threaded through the
serving stack (``Engine(..., telemetry=...)``):

* **metrics** (:mod:`repro_torch.obs.metrics`) — Counter/Gauge/Histogram
  with fixed log-spaced buckets, Prometheus text exposition adapted from
  the engine's live :class:`~repro_torch.serving.metrics.EngineStats`,
  an optional stdlib ``/metrics`` endpoint, and the shared exposition
  validator;
* **tracing** (:mod:`repro_torch.obs.trace`) — per-request span
  timelines in Chrome trace-event JSON, loadable in Perfetto;
* **events** (:mod:`repro_torch.obs.events`) — structured ring-buffered
  event log (rung switches with reasons, gamma changes, prefix
  evictions, KV rollbacks, graph builds) with an optional JSONL sink;
* **profiler** (:mod:`repro_torch.obs.profiler`) — per-dispatch
  ``torch.profiler.record_function`` ranges and an opt-in
  ``torch.profiler`` capture window exporting a Chrome trace;
* **quality** (:mod:`repro_torch.obs.quality`) — shadow dense probes,
  online Eq. 6 reconstruction error, saliency drift and per-rung roofline
  counters (:class:`QualityMonitor`);
* **flight** (:mod:`repro_torch.obs.flight`) — capture of the engine's
  submissions, clock reads and decisions for bit-identical replay
  (:class:`FlightRecorder`, ``python -m repro_torch.obs.flight.replay``).

The default engine configuration uses :data:`NULL_TELEMETRY`: every
surface is ``None``, every hot-path emit site is an ``is not None``
check, and :meth:`Telemetry.annotate` returns a shared reusable null
context — the disabled path allocates nothing.

Clock discipline: all serving timestamps come from :func:`now`
(monotonic; :mod:`repro_torch.obs.clock`), so spans, events, stats and
snapshots are mutually orderable; the engine reads it through an
injected clock (:data:`SYSTEM_CLOCK` by default, a :class:`ReplayClock`
under replay).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.clock import (SYSTEM_CLOCK, ReplayClock,
                                   ReplayDivergence, SystemClock, now,
                                   to_wall)
from repro_torch.obs.events import EventLog
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, engine_exposition,
                                     engine_registry, log_buckets,
                                     parse_exposition, serve_metrics,
                                     validate_exposition)
from repro_torch.obs.profiler import (NULL_CONTEXT, ProfilerSession,
                                      annotation)
from repro_torch.obs.quality import QualityConfig, QualityMonitor
from repro_torch.obs.trace import SpanTracer, validate_chrome_trace


@dataclasses.dataclass
class Telemetry:
    """Per-engine telemetry bundle.  Any surface may be ``None`` (off);
    the all-``None`` default is :data:`NULL_TELEMETRY` and costs nothing
    on the hot path.

    ``annotate_dispatch`` arms per-dispatch profiler ranges;
    ``profiler`` is an opt-in capture-window session the caller
    starts/stops around the region it wants profiled.  ``trace_sink``:
    when set (and a tracer is armed), :meth:`close` exports the Chrome
    trace JSON there, so ``Engine.close()`` flushes every sink even when
    the driving loop raised.  ``quality``: the sparsity-quality probes,
    armed by ``Engine.warmup()``.  ``flight``: the flight recorder, which
    the engine attaches at construction (wrapping its injected clock).
    ``None`` keeps each to an ``is not None`` check per emit site."""

    tracer: Optional[SpanTracer] = None
    events: Optional[EventLog] = None
    annotate_dispatch: bool = False
    profiler: Optional[ProfilerSession] = None
    trace_sink: Optional[str] = None
    quality: Optional[QualityMonitor] = None
    flight: Optional[FlightRecorder] = None

    @property
    def enabled(self) -> bool:
        return (self.tracer is not None or self.events is not None
                or self.annotate_dispatch or self.profiler is not None
                or self.quality is not None or self.flight is not None)

    def annotate(self, name: str):
        """Context manager for one dispatch: a profiler range when
        armed, the shared null context (no allocation) otherwise."""
        if not self.annotate_dispatch:
            return NULL_CONTEXT
        return annotation(name)

    @classmethod
    def full(cls, events_sink=None, profile_dir: Optional[str] = None,
             event_capacity: int = 4096,
             quality: Optional[QualityConfig] = None) -> "Telemetry":
        """Everything on: tracer + event log (+ optional JSONL sink) +
        dispatch annotations (+ a capture session when ``profile_dir``
        is given, left for the caller to start; + quality probes when a
        :class:`QualityConfig` is given)."""
        return cls(
            tracer=SpanTracer(),
            events=EventLog(capacity=event_capacity, sink=events_sink),
            annotate_dispatch=True,
            profiler=ProfilerSession(profile_dir) if profile_dir else None,
            quality=QualityMonitor(quality) if quality is not None
            else None)

    def close(self) -> None:
        """Flush and close every armed sink.  Idempotent: profiler stop,
        event-log close and trace re-export all tolerate repeat calls."""
        if self.profiler is not None:
            self.profiler.stop()
        if self.tracer is not None and self.trace_sink is not None:
            self.tracer.export(self.trace_sink)
        if self.events is not None:
            self.events.close()
        if self.flight is not None:
            self.flight.close()


NULL_TELEMETRY = Telemetry()

__all__ = [
    "Telemetry", "NULL_TELEMETRY", "now", "to_wall",
    "SystemClock", "SYSTEM_CLOCK", "ReplayClock", "ReplayDivergence",
    "SpanTracer", "validate_chrome_trace",
    "EventLog", "FlightRecorder",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
    "engine_registry", "engine_exposition", "parse_exposition",
    "validate_exposition", "serve_metrics",
    "ProfilerSession", "annotation", "NULL_CONTEXT",
    "QualityConfig", "QualityMonitor",
]
