"""Fault-tolerant training runner (port of the JAX package's
``distributed/fault_tolerance.py``).

  * checkpoint/restart: periodic (async) checkpoints with an atomic
    publish and exact resume: the data stream is deterministic in
    (seed, host, step), so a restart replays from the checkpointed step
    bit-identically;
  * preemption handling: the runner traps failures (a ``FailureInjector``
    simulates SIGTERM-style preemptions in tests), restores the latest
    checkpoint and continues; crash loops are bounded by ``max_restarts``;
  * straggler flagging: a per-step watchdog on ``obs.clock.now`` records
    steps slower than ``straggler_factor`` x the recent median.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.obs.clock import now


class Preemption(Exception):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministic simulated preemptions (for tests/demos)."""
    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise Preemption(f"simulated preemption at step {step}")


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int
    checkpoint_every: int = 50
    max_restarts: int = 10
    straggler_factor: float = 3.0   # step slower than factor x median -> flag


class TrainingRunner:
    def __init__(self, cfg: RunnerConfig, ckpt: CheckpointManager,
                 injector: Optional[FailureInjector] = None, log=print):
        self.cfg = cfg
        self.ckpt = ckpt
        self.injector = injector
        self.log = log
        self.straggler_events = []
        self.restarts = 0

    def run(self, state, step_fn: Callable, batch_fn: Callable,
            state_axes=None, metadata: Optional[dict] = None):
        """state: a tree; step_fn(state, batch) -> (state, metrics);
        batch_fn(step) -> batch.  Returns the final state."""
        restored, meta = self.ckpt.restore(state, axes_tree=state_axes)
        start = 0
        if restored is not None:
            state, start = restored, int(meta["step"])
            self.log(f"resumed from step {start}")
        step = start
        durations = []
        while step < self.cfg.total_steps:
            try:
                t0 = now()
                if self.injector:
                    self.injector.check(step)
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                dt = now() - t0
                durations.append(dt)
                med = float(np.median(durations[-20:]))
                if len(durations) > 5 and dt > self.cfg.straggler_factor * med:
                    self.straggler_events.append((step, dt, med))
                    self.log(f"straggler: step {step} took {dt:.3f}s "
                             f"(median {med:.3f}s)")
                step += 1
                if step % self.cfg.checkpoint_every == 0 \
                        or step == self.cfg.total_steps:
                    self.ckpt.save(step, state, metadata)
            except Preemption as e:
                self.restarts += 1
                self.log(f"{e} -> restart {self.restarts}")
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                restored, meta = self.ckpt.restore(state, axes_tree=state_axes)
                if restored is not None:
                    state, step = restored, int(meta["step"])
                else:
                    step = 0
        self.ckpt.wait()
        return state
