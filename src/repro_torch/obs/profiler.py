"""Profiler integration: dispatch annotations and capture windows (the
port's counterpart of the JAX package's ``obs/profiler.py``, on
``torch.profiler``).

Two layers, both opt-in:

* :func:`annotation` — a ``torch.profiler.record_function`` range
  labelling the host-side dispatch of one engine step (decode, chunk,
  verify, prefix copies), so engine phases show up as named ranges in a
  captured profile.  When telemetry is off the engine gets the shared
  :data:`NULL_CONTEXT` instead — a reusable, reentrant
  ``contextlib.nullcontext`` (no allocation on the hot path).
  Annotations wrap the *dispatch* (a graph replay on the card), never a
  capture, so they cannot change what a graph holds.

* :class:`ProfilerSession` — an explicit capture window: a
  ``torch.profiler.profile`` over the CPU and, when a card is present,
  CUDA activities, which exports a Chrome trace into ``out_dir`` on
  :meth:`stop` (one ``profile-<k>.json`` per window).  Kernels launched
  by a CUDA-graph replay appear in it by name.  Wrapped defensively:
  a profiler backend that fails must degrade to an error string, not
  kill serving.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

NULL_CONTEXT = contextlib.nullcontext()


def annotation(name: str):
    """A profiler range context for one dispatch."""
    return torch.profiler.record_function(name)


class ProfilerSession:
    """Opt-in profiler capture window writing to ``out_dir``.

    ``start()``/``stop()`` are idempotent and swallow profiler-backend
    errors (recorded on ``.error``) — telemetry must never take down the
    engine it observes.  ``trace_path`` is the last exported trace."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.active = False
        self.error: Optional[str] = None
        self.trace_path: Optional[str] = None
        self.windows = 0
        self._prof = None

    def start(self) -> bool:
        if self.active:
            return True
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:                      # noqa: BLE001
            self.error = f"profiler start failed: {e}"
            return False
        self._prof = prof
        self.active = True
        return True

    def stop(self) -> bool:
        if not self.active:
            return False
        self.active = False
        prof, self._prof = self._prof, None
        path = os.path.join(self.out_dir, f"profile-{self.windows}.json")
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(self.out_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception as e:                      # noqa: BLE001
            self.error = f"profiler stop/export failed: {e}"
            return False
        self.windows += 1
        self.trace_path = path
        return True

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
