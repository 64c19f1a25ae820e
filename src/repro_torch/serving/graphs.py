"""The serving engine's steps, each built once (the counterpart of the
JAX package's jitted ``_decode``, ``_chunk`` and verify steps in
``serving/engine.py:make_engine_steps`` and ``serving/spec.py``, which
compile once per static policy and shape).

On the card one step of full-width llama31_8b is some two thousand
small kernels, and launching them one by one from Python costs several
times their device time.  So each step is captured once as a CUDA graph
and replayed:

- :class:`DecodeSteps`: the batched slot-decode step, one graph per
  ladder rung;
- :class:`ChunkSteps`: one request's prefill chunk at ``(1, C)``, one
  graph per (rung, prefill phase policy);
- :class:`VerifySteps`: the speculative verify at ``(S, gamma + 1)``,
  one graph per draft length gamma.

Each keeps static input buffers, filled with ``copy_`` (or ``fill_``)
before a replay; the pool caches are written in place, and the params
and sp trees are captured by address (they outlive the graphs: the
engine holds them).  A graph is captured after one eager warm call on a
side stream (library build, cuBLAS handles, allocator), with inactive
inputs that write only the pool's slack, past every position a request
can hold: a decode step the scratch position, a chunk the ``C``
positions from ``max_len``, a verify the last ``gamma + 1`` positions.
A build in the middle of serving therefore never touches a live
request's cache.  The steps never run at once, so every graph of an
engine shares one memory pool (:class:`GraphSpace`).

A capture or a replay that fails raises; nothing falls back to eager.
Before the first capture of any kind the split-K scratch of the matmul
kernels is reserved for every launch the engine can make, and each
graph keeps references to the scratch it captured
(``kernels/sparse_matmul.reserve_matmul_scratch``).

On the CPU the same objects call the plain step functions eagerly.
Either way a build is counted once per key, so the engine's
``*_retraces_after_warmup`` keep the reference's meaning.

The kernel wrappers count a launch where Python calls them, so a launch
recorded while capturing counts once, and its replays count nothing;
:func:`launches` turns the wrappers' counts into the launches that ran.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import sparse_matmul as K


class GraphSpace:
    """What an engine's captured steps share: the device, one graph
    memory pool, and the ``(B, n, m, blk, elem_bytes)`` matmul shapes
    whose split-K scratch is reserved before the first capture."""

    def __init__(self, device: torch.device,
                 reserve: Sequence[Tuple[int, int, int, int, int]] = ()):
        self.device = device
        self.cuda = device.type == "cuda"
        self._reserve = list(reserve)
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    @torch.no_grad()
    def capture(self, run):
        """One eager warm call of ``run()`` on a side stream, then its
        capture.  Returns (graph, run's outputs in the graph's memory,
        the kernel launches recorded while capturing, the split-K scratch
        the graph writes)."""
        for args in self._reserve:
            K.reserve_matmul_scratch(*args[:4], self.device, args[4])
        self._reserve = []
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        c1 = dict(K.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            outs = run()
        c2 = dict(K.launch_counts)
        # the graph writes the scratch it captured: hold it for as long
        # as the graph lives
        return (graph, outs, {k: c2[k] - c1[k] for k in c1},
                K.scratch_tensors(self.device))


class _Steps:
    """Steps built once per key.  ``builds`` counts keys built; per key,
    ``steps`` counts the steps run (graph replays on the card),
    ``captured`` the kernel launches recorded while capturing its graph
    and ``scratch`` the split-K scratch its graph writes, held for the
    graph's lifetime (both empty on the CPU)."""

    def __init__(self, keys: Sequence, space: GraphSpace):
        self.keys = list(keys)
        self._index = {k: i for i, k in enumerate(self.keys)}
        self.space = space
        self.device = space.device
        n = len(self.keys)
        self.builds = 0
        self.steps: List[int] = [0] * n
        self.captured: List[Dict[str, int]] = [{} for _ in range(n)]
        self.scratch: List[tuple] = [() for _ in range(n)]
        self._built = [False] * n
        self._graphs: List[Optional[tuple]] = [None] * n

    def __len__(self) -> int:
        return len(self.keys)

    def built(self, i: int) -> bool:
        return self._built[i]

    def build(self, i: int) -> None:
        """Build step ``i`` once: on the card, one eager warm call and the
        capture of its graph, with the inactive inputs."""
        if self._built[i]:
            return
        self.builds += 1
        if self.space.cuda:
            self._inactive(i)
            graph, outs, self.captured[i], self.scratch[i] = \
                self.space.capture(lambda: self._run(i))
            self._graphs[i] = (graph,) + tuple(outs)
        self._built[i] = True

    def _replay(self, i: int) -> tuple:
        """Replay step ``i``'s graph (built before its inputs were
        filled: a build resets them to the inactive values)."""
        self.steps[i] += 1
        graph, *outs = self._graphs[i]
        graph.replay()
        return tuple(outs)

    # the static inputs' inactive values, and one step on them
    def _inactive(self, i: int) -> None:
        raise NotImplementedError

    def _run(self, i: int) -> tuple:
        raise NotImplementedError


def launches(counts: Dict[str, int], *steps: _Steps) -> Dict[str, int]:
    """The kernel launches that ran over a span whose wrapper counts are
    ``counts``, where the span holds every build and step of ``steps``:
    each launch recorded while capturing a graph ran once per replay of
    it, not at the capture (its eager warm call ran once and counted
    once)."""
    out = dict(counts)
    for s in steps:
        for cap, n in zip(s.captured, s.steps):
            for k, v in cap.items():
                out[k] += v * (n - 1)
    return out


class DecodeSteps(_Steps):
    """One batched slot-decode step per rung.

    ``step`` is ``api.make_slot_decode_step(cfg)``; ``rungs`` lists each
    rung's (decode-phase policy, sp tree).  Inactive slots write
    ``scratch_pos``."""

    def __init__(self, step, params, caches, rungs: Sequence[tuple],
                 max_slots: int, scratch_pos: int, space: GraphSpace):
        super().__init__(range(len(rungs)), space)
        self._step = step
        self._params = params
        self._caches = caches
        self._rungs = list(rungs)
        self._scratch_pos = scratch_pos
        if space.cuda:
            S, dev = max_slots, space.device
            self._tokens = torch.zeros(S, dtype=torch.long, device=dev)
            self._positions = torch.full((S,), scratch_pos, dtype=torch.long,
                                         device=dev)
            self._active = torch.zeros(S, dtype=torch.float32, device=dev)

    def eager(self, rung: int, tokens, positions, active):
        """The plain step of ``rung`` on device copies of the numpy
        inputs -> f32 logits (S, V); the pool caches are written in
        place."""
        dev = self.device
        return self._eager(rung, torch.from_numpy(tokens).to(dev),
                           torch.from_numpy(positions).to(dev),
                           torch.from_numpy(active).to(dev))

    def _eager(self, rung, tokens, positions, active):
        policy, sp = self._rungs[rung]
        logits, _ = self._step(self._params, tokens, positions,
                               self._caches, sp, active, policy=policy)
        return logits

    def _inactive(self, rung: int) -> None:
        self._tokens.zero_()
        self._positions.fill_(self._scratch_pos)
        self._active.zero_()

    def _run(self, rung: int) -> tuple:
        logits = self._eager(rung, self._tokens, self._positions,
                             self._active)
        return logits, torch.argmax(logits, -1)

    def __call__(self, rung: int, tokens: np.ndarray, positions: np.ndarray,
                 active: np.ndarray):
        """One decode step of ``rung`` on numpy inputs -> (greedy tokens
        (S,) numpy, f32 logits (S, V))."""
        nxt, logits = self.replay(rung, torch.from_numpy(tokens),
                                  torch.from_numpy(positions),
                                  torch.from_numpy(active))
        return nxt.cpu().numpy(), logits

    def replay(self, rung: int, tokens: torch.Tensor,
               positions: torch.Tensor, active: torch.Tensor):
        """One decode step of ``rung`` -> (greedy tokens (S,), f32 logits
        (S, V)) on the device, with no host read (the draft loop of
        speculative decoding feeds one step's tokens to the next).  On
        the card both are the graph's static outputs, overwritten by the
        next replay of that rung."""
        self.build(rung)
        if not self.space.cuda:
            self.steps[rung] += 1
            logits = self._eager(rung, tokens, positions, active)
            return torch.argmax(logits, -1), logits
        self._tokens.copy_(tokens)
        self._positions.copy_(positions)
        self._active.copy_(active)
        logits, nxt = self._replay(rung)
        return nxt, logits


class ChunkSteps(_Steps):
    """One request's prefill chunk at ``(1, C)``, one step per (rung,
    prefill phase policy): ``rungs`` lists each rung's (prefill-dense
    policy, prefill-sparse policy, sp tree), and a rung whose two phase
    policies are equal has one step.

    ``step`` is ``api.make_chunk_prefill_step(cfg)``.  The inactive
    inputs write the ``C`` positions from ``slack`` (the engine's
    ``max_len``) of slot 0."""

    def __init__(self, step, params, caches, rungs: Sequence[tuple],
                 chunk: int, slack: int, space: GraphSpace):
        keys, self._progs = [], []
        for r, (pd, ps, sp) in enumerate(rungs):
            for pol in (pd, ps):
                if (r, pol) not in keys:
                    keys.append((r, pol))
                    self._progs.append((pol, sp))
        super().__init__(keys, space)
        self._step = step
        self._params = params
        self._caches = caches
        self._slack = slack
        if space.cuda:
            dev = space.device
            self._tokens = torch.zeros((1, chunk), dtype=torch.long,
                                       device=dev)
            self._offset = torch.full((1,), slack, dtype=torch.long,
                                      device=dev)
            self._slot = torch.zeros((), dtype=torch.long, device=dev)
            self._weights = torch.zeros(chunk, dtype=torch.float32,
                                        device=dev)

    def index(self, rung: int, policy) -> int:
        return self._index[(rung, policy)]

    def eager(self, i: int, tokens: np.ndarray, offset: int, slot: int,
              weights: np.ndarray):
        """The plain chunk step ``i`` on device copies of the inputs ->
        f32 logits (1, C, V); the pool caches are written in place."""
        dev = self.device
        return self._eager(i, torch.from_numpy(tokens).to(dev),
                           torch.full((1,), offset, dtype=torch.long,
                                      device=dev),
                           torch.tensor(slot, dtype=torch.long, device=dev),
                           torch.from_numpy(weights).to(dev))

    def _eager(self, i, tokens, offset, slot, weights):
        policy, sp = self._progs[i]
        logits, _ = self._step(self._params, tokens, offset, slot,
                               self._caches, sp, weights, policy=policy)
        return logits

    def _inactive(self, i: int) -> None:
        self._tokens.zero_()
        self._offset.fill_(self._slack)
        self._slot.zero_()
        self._weights.zero_()

    def _run(self, i: int) -> tuple:
        return (self._eager(i, self._tokens, self._offset, self._slot,
                            self._weights),)

    def __call__(self, i: int, tokens: np.ndarray, offset: int, slot: int,
                 weights: np.ndarray):
        """One chunk step ``i`` -> f32 logits (1, C, V).  On the card the
        logits are the graph's static output, overwritten by its next
        replay."""
        self.build(i)
        if not self.space.cuda:
            self.steps[i] += 1
            return self.eager(i, tokens, offset, slot, weights)
        self._tokens.copy_(torch.from_numpy(tokens))
        self._offset.fill_(offset)
        self._slot.fill_(slot)
        self._weights.copy_(torch.from_numpy(weights))
        return self._replay(i)[0]


class VerifySteps(_Steps):
    """The speculative verify at ``(S, gamma + 1)``, one step per draft
    length in ``gammas``, under the verifier's (policy, sp tree).

    ``step`` is ``api.make_verify_step(cfg)``.  The inactive inputs put
    every slot's window at the pool's last ``gamma + 1`` positions."""

    def __init__(self, step, params, caches, policy, sp,
                 gammas: Sequence[int], max_slots: int, pool_len: int,
                 space: GraphSpace):
        super().__init__(gammas, space)
        self._step = step
        self._params = params
        self._caches = caches
        self._policy, self._sp = policy, sp
        self._pool_len = pool_len
        if space.cuda:
            S, dev = max_slots, space.device
            self._positions = torch.zeros(S, dtype=torch.long, device=dev)
            self._static = {
                g: (torch.zeros((S, g + 1), dtype=torch.long, device=dev),
                    torch.zeros((S, g + 1), dtype=torch.float32,
                                device=dev))
                for g in self.keys}

    def eager(self, tokens, positions, weights):
        """The plain verify on device inputs (its gamma is tokens'
        width less one) -> f32 logits (S, g+1, V); the pool caches are
        written in place."""
        logits, _ = self._step(self._params, tokens, positions,
                               self._caches, self._sp, weights,
                               policy=self._policy)
        return logits

    def _inactive(self, i: int) -> None:
        g = self.keys[i]
        tokens, weights = self._static[g]
        tokens.zero_()
        weights.zero_()
        self._positions.fill_(self._pool_len - (g + 1))

    def _run(self, i: int) -> tuple:
        tokens, weights = self._static[self.keys[i]]
        logits = self.eager(tokens, self._positions, weights)
        return logits, torch.argmax(logits, -1)

    def __call__(self, gamma: int, tokens: torch.Tensor,
                 positions: torch.Tensor, weights: torch.Tensor):
        """One verify at draft length ``gamma`` on device inputs ->
        (the verifier's greedy tokens (S, g+1), f32 logits (S, g+1, V)),
        both on the device; on the card the graph's static outputs."""
        i = self._index[gamma]
        self.build(i)
        if not self.space.cuda:
            self.steps[i] += 1
            logits = self.eager(tokens, positions, weights)
            return torch.argmax(logits, -1), logits
        static_tokens, static_weights = self._static[gamma]
        static_tokens.copy_(tokens)
        self._positions.copy_(positions)
        static_weights.copy_(weights)
        logits, ver = self._replay(i)
        return ver, logits
