"""Per-request span tracing in Chrome trace-event JSON, Perfetto-loadable
(port of the JAX package's ``obs/trace.py``; stdlib only, copied).

The engine owns one :class:`SpanTracer` per run (via
``Telemetry.tracer``).  Spans are *complete* events ("ph": "X") recorded
after the fact from the engine's existing ``t0``/``t1`` monotonic stamps
— no context managers on the hot path, one dict append per span.  The
track layout maps the serving model directly:

* ``tid 0`` ("engine") — batched phase steps: decode steps, spec
  draft/verify/commit phases, with batch size / rung / gamma as args;
* ``tid request_id + 1`` ("req-<id>") — each request's timeline:
  ``submit`` → ``admit`` (slot) → ``prefix_lookup`` (matched length) →
  per-chunk ``prefill_chunk`` spans → ``first_token`` → ``finish``
  (reason), plus per-round ``rollback`` instants under spec decoding.

Counter events ("ph": "C") chart queue depth and slot occupancy as
Perfetto counter tracks.  Timestamps are microseconds since the
tracer's creation, taken from the shared monotonic clock
(:mod:`repro_torch.obs.clock`) so spans, events, and stats are mutually
orderable.  Load the exported file at https://ui.perfetto.dev (legacy
JSON is auto-detected) or ``chrome://tracing``.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.obs import clock

ENGINE_TID = 0
TRACE_PID = 1

_ALLOWED_PH = {"X", "i", "I", "C", "M", "B", "E"}


class SpanTracer:
    """In-memory Chrome trace-event recorder.  Append-only; ``export``
    (or ``to_dict``) at end of run.  One list append per span — cheap
    enough for per-chunk/per-step granularity, and absent entirely when
    tracing is off (the engine checks ``tracer is not None``)."""

    def __init__(self, origin: Optional[float] = None):
        self.origin = clock.now() if origin is None else origin
        self.events = []
        self._named: Dict[int, str] = {}
        self.thread_name(ENGINE_TID, "engine")

    # ------------------------------------------------------------------
    def _ts(self, t: float) -> float:
        return (t - self.origin) * 1e6      # trace-event ts unit: us

    def thread_name(self, tid: int, name: str) -> None:
        """Label a track (emitted once per tid; later names are kept)."""
        if tid in self._named:
            return
        self._named[tid] = name
        self.events.append({"ph": "M", "name": "thread_name",
                            "pid": TRACE_PID, "tid": tid,
                            "args": {"name": name}})

    def complete(self, name: str, t0: float, t1: float,
                 tid: int = ENGINE_TID, **args) -> None:
        """One finished span [t0, t1] (monotonic seconds)."""
        self.events.append({"ph": "X", "name": name, "pid": TRACE_PID,
                            "tid": tid, "ts": self._ts(t0),
                            "dur": max(0.0, (t1 - t0) * 1e6),
                            "args": args})

    def instant(self, name: str, t: Optional[float] = None,
                tid: int = ENGINE_TID, **args) -> None:
        self.events.append({"ph": "i", "name": name, "pid": TRACE_PID,
                            "tid": tid, "s": "t",
                            "ts": self._ts(clock.now() if t is None else t),
                            "args": args})

    def counter(self, name: str, t: Optional[float] = None, **values) -> None:
        """Counter track sample (Perfetto draws these as line charts)."""
        self.events.append({"ph": "C", "name": name, "pid": TRACE_PID,
                            "tid": ENGINE_TID,
                            "ts": self._ts(clock.now() if t is None else t),
                            "args": values})

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


def validate_chrome_trace(doc) -> int:
    """Assert ``doc`` (a parsed trace JSON object) is schema-valid
    Chrome trace-event JSON: a ``traceEvents`` list whose entries carry
    the per-phase required keys with sane types (non-negative ``dur`` on
    complete events, ``ts`` on every timed event).  Returns the event
    count; raises ``ValueError`` on violations.  Shared by the tests and
    the CI artifact check."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with a traceEvents list")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            raise ValueError(f"event {i}: bad phase {ph!r}")
        for key in ("name", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i}: missing {key!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event {i}: missing/bad ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: complete event needs "
                                 f"dur >= 0, got {dur!r}")
        if "args" in ev:
            json.dumps(ev["args"])       # args must be JSON-serializable
    return len(events)
