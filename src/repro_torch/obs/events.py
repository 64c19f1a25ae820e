"""Structured event log: the *why* behind the metrics (port of the JAX
package's ``obs/events.py``; stdlib only, copied).

Latency series say a TPOT regression happened; the event log says what
the engine *did* at that moment — a rung switch and the controller's
reason (TPOT-over-target vs queue pressure vs de-escalation), a gamma
or drafter change, a prefix-cache eviction, a speculative-decode KV
rollback, a graph build (``compile``: one capture of a decode, chunk
or verify step), or (the invariant-violation case) a build after
warmup.

Events are plain dicts ``{"t": monotonic_s, "kind": str, ...fields}``
ring-buffered in memory (bounded — a long-running server cannot grow it
without limit) with an optional always-flushed JSONL sink for offline
analysis.  Timestamps come from the shared monotonic clock so events
line up with spans and stats.  Emission is one dict build + deque
append; when no :class:`EventLog` is armed the engine's emit sites are
``if events is not None`` checks — allocation-free.

The JSONL sink can itself be bounded (``max_sink_bytes``): when the log
owns the file (path sink) and a write pushes it past the budget, the
file rotates once to ``<path>.1`` (replacing any previous rotation) and
a fresh file continues — a long-running serve keeps at most ~2x the
budget on disk, and the in-memory ring is never touched by rotation.
"""
from __future__ import annotations

import collections
import json
import os
from typing import List, Optional

from repro_torch.obs import clock


class EventLog:
    """Bounded in-memory event ring with an optional JSONL sink.

    ``sink`` is a path (opened append) or a file-like with ``write``;
    each event is written and flushed immediately so a crash loses
    nothing.  ``count`` is the whole-run total; the ring keeps the most
    recent ``capacity`` events.

    ``max_sink_bytes`` (path sinks only — the log must own the file to
    rotate it) caps the JSONL file: when a write would exceed the
    budget, the current file moves to ``<path>.1`` and writing restarts
    on an empty file.  0 means unbounded (the historical behaviour)."""

    def __init__(self, capacity: int = 4096, sink=None,
                 max_sink_bytes: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if max_sink_bytes < 0:
            raise ValueError(
                f"max_sink_bytes must be >= 0, got {max_sink_bytes}")
        if max_sink_bytes and not isinstance(sink, str):
            raise ValueError(
                "max_sink_bytes needs a path sink: rotation renames the "
                "file, which only the log-owned (path) sink allows")
        self.capacity = capacity
        self.max_sink_bytes = max_sink_bytes
        self.sink_rotations = 0
        self._ring = collections.deque(maxlen=capacity)
        self.count = 0
        self._fh = None
        self._owns_fh = False
        self._sink_path: Optional[str] = None
        self._sink_bytes = 0
        if isinstance(sink, str):
            # held for the log's lifetime, closed in close()/rotation
            self._fh = open(sink, "a")  # noqa: SIM115
            self._owns_fh = True
            self._sink_path = sink
            self._sink_bytes = self._fh.tell()
        elif sink is not None:
            self._fh = sink

    # ------------------------------------------------------------------
    def emit(self, kind: str, t: Optional[float] = None, **fields) -> None:
        rec = {"t": clock.now() if t is None else t, "kind": kind}
        rec.update(fields)
        self._ring.append(rec)
        self.count += 1
        if self._fh is not None:
            line = json.dumps(rec) + "\n"
            if (self.max_sink_bytes and self._sink_path is not None
                    and self._sink_bytes
                    and self._sink_bytes + len(line) > self.max_sink_bytes):
                self._rotate()
            self._fh.write(line)
            self._fh.flush()
            self._sink_bytes += len(line)

    def _rotate(self) -> None:
        """Move the full sink file aside to ``<path>.1`` and continue on
        a fresh one.  The in-memory ring is untouched — rotation bounds
        only the on-disk history."""
        self._fh.close()
        os.replace(self._sink_path, self._sink_path + ".1")
        self._fh = open(self._sink_path, "w")  # noqa: SIM115
        self._sink_bytes = 0
        self.sink_rotations += 1

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Retained events, oldest first, optionally filtered by kind."""
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e["kind"] == kind]

    def __len__(self) -> int:
        return len(self._ring)

    def close(self) -> None:
        if self._fh is not None and self._owns_fh:
            self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
