"""One monotonic clock for the port's serving stack (port of the JAX
package's ``obs/clock.py``).

Every serving timestamp routes through :func:`now`, so engine stats,
spans, events and CLI timings are mutually orderable.  :func:`to_wall`
maps a monotonic timestamp to approximate epoch seconds for human-facing
output only.

Injectable clocks: the serving engine reads time through an injected
clock object (``Engine(..., clock=...)``), defaulting to the shared
:data:`SYSTEM_CLOCK` singleton.  The flight recorder
(``repro_torch.obs.flight``) wraps that clock to log every observation,
and a replay substitutes a :class:`ReplayClock` that feeds the recorded
timestamps back verbatim, so every controller input (inter-token gaps,
deadline sweeps, EWMA updates) is bit-identical to the recorded run.

This module holds the port's only raw clock reads: the monotonic clock,
and the wall clock once at import for :func:`to_wall`."""
from __future__ import annotations

import time
from typing import Optional, Sequence


def now() -> float:
    """Monotonic seconds — THE serving timestamp source."""
    return time.monotonic()  # repro: ignore[no-raw-time] -- this module is the port's clock


# the approximate offset between the wall and the monotonic clock, taken
# once at import
_WALL_OFFSET = time.time() - now()  # repro: ignore[no-raw-time] -- the wall offset of to_wall


def to_wall(t_mono: float) -> float:
    """Approximate wall-clock epoch seconds for a :func:`now` timestamp
    (human-facing logs only; durations must subtract monotonic stamps)."""
    return t_mono + _WALL_OFFSET


class SystemClock:
    """The live clock: every ``now(site)`` is a fresh monotonic read.
    ``site`` is a call-site tag (e.g. ``"decode.t1"``) that the flight
    recorder logs next to each observation so a replay divergence names
    the exact consuming site; the live clock ignores it."""

    __slots__ = ()

    def now(self, site: str = "") -> float:
        return now()


# the shared default: engines built without an explicit clock use this
# exact object, so the clock-off path is testable by identity
SYSTEM_CLOCK = SystemClock()


class ReplayDivergence(RuntimeError):
    """Replay consumed the recording differently than the live run: the
    engine asked for a clock read where the recording holds another
    record kind (or no record at all), or the consuming call site
    changed.  ``detail`` is the structured first-divergence report
    (record index, expected against got) the replay CLI prints."""

    def __init__(self, message: str, detail: Optional[dict] = None):
        super().__init__(message)
        self.detail = detail or {}


class ReplayClock:
    """Feeds recorded timestamps back to the engine, positionally.

    Holds the recording's ordered input records (clock reads and request
    submissions) and a shared cursor: the replay loop advances the
    cursor over ``submit`` records (re-issuing each submission), and
    every engine clock read consumes the ``clock`` record at the cursor.
    Any mismatch raises :class:`ReplayDivergence` with a structured
    detail dict instead of silently desynchronizing."""

    def __init__(self, inputs: Sequence[dict]):
        self.inputs = list(inputs)
        self.cursor = 0

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self.inputs)

    def peek(self) -> Optional[dict]:
        if self.exhausted:
            return None
        return self.inputs[self.cursor]

    def now(self, site: str = "") -> float:
        rec = self.peek()
        if rec is None:
            raise ReplayDivergence(
                f"replay clock exhausted: the engine read the clock at "
                f"site {site!r} but all {len(self.inputs)} recorded "
                f"inputs are already consumed",
                detail={"record": self.cursor, "expected": None,
                        "got": {"k": "clock", "s": site}})
        if rec.get("k") != "clock":
            raise ReplayDivergence(
                f"replay desynchronized at record {self.cursor}: the "
                f"engine read the clock at site {site!r} but the "
                f"recording holds a {rec.get('k')!r} record there",
                detail={"record": self.cursor, "expected": rec,
                        "got": {"k": "clock", "s": site}})
        want = rec.get("s", "")
        if want and site and want != site:
            raise ReplayDivergence(
                f"replay desynchronized at record {self.cursor}: clock "
                f"read from site {site!r} but the recording's read came "
                f"from {want!r}",
                detail={"record": self.cursor, "expected": rec,
                        "got": {"k": "clock", "s": site}})
        self.cursor += 1
        return float(rec["t"])
