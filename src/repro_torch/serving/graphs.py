"""The serving engine's batched decode step, built once per ladder rung
(the counterpart of the JAX package's jitted ``_decode`` in
``serving/engine.py:make_engine_steps``, which compiles once per rung).

On the card a decode step of full-width llama31_8b is some two thousand
small kernels, and launching them one by one from Python costs several
times their device time.  So each rung's step is captured once as a
CUDA graph and replayed:

- static input buffers for the tokens, positions and active-slot mask,
  filled with ``copy_`` before each replay;
- the pool caches are written in place, and each rung's params and sp
  tree are captured by address (they outlive the graph: the engine
  holds them);
- the greedy argmax is inside the graph, and one host read follows each
  replay;
- a rung's graph is captured once, after one eager warm step on a side
  stream (library build, cuBLAS handles, allocator), with inactive
  inputs that write only the pool's scratch position;
- rung graphs never run at once, so they share one memory pool.

A capture or a replay that fails raises; nothing falls back to eager.
Before the first capture the split-K scratch of the matmul kernels is
reserved for every launch the engine can make, and each graph keeps
references to the scratch it captured
(``kernels/sparse_matmul.reserve_matmul_scratch``).

On the CPU the same object calls the plain step function eagerly.
Either way a build is counted once per rung, so
``Engine.decode_retraces_after_warmup`` keeps the reference's meaning.

The kernel wrappers count a launch where Python calls them, so a launch
recorded while capturing counts once, and its replays count nothing;
:meth:`DecodeSteps.launches` turns the wrappers' counts into the
launches that ran.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import sparse_matmul as K


class DecodeSteps:
    """One batched slot-decode step per rung.

    ``step`` is ``api.make_slot_decode_step(cfg)``; ``rungs`` lists each
    rung's (decode-phase policy, sp tree); ``reserve`` lists the
    ``(B, n, m, blk, elem_bytes)`` matmul shapes whose split-K scratch
    is reserved before the first capture.

    ``builds`` counts rung steps built; per rung, ``steps`` counts the
    decode steps run (graph replays on the card), ``captured`` the
    kernel launches recorded while capturing its graph and ``scratch``
    the split-K scratch tensors its graph writes, held for the graph's
    lifetime (both empty on the CPU)."""

    def __init__(self, step, params, caches, rungs: Sequence[tuple],
                 max_slots: int, scratch_pos: int, device: torch.device,
                 reserve: Sequence[Tuple[int, int, int, int, int]] = ()):
        self._step = step
        self._params = params
        self._caches = caches
        self._rungs = list(rungs)
        self.device = device
        n = len(self._rungs)
        self.builds = 0
        self.steps: List[int] = [0] * n
        self.captured: List[Dict[str, int]] = [{} for _ in range(n)]
        self.scratch: List[tuple] = [() for _ in range(n)]
        self._built = [False] * n
        self._graphs: List[Optional[tuple]] = [None] * n
        self._reserve = list(reserve)
        self._cuda = device.type == "cuda"
        self._scratch_pos = scratch_pos
        if self._cuda:
            S = max_slots
            self._tokens = torch.zeros(S, dtype=torch.long, device=device)
            self._positions = torch.full((S,), scratch_pos, dtype=torch.long,
                                         device=device)
            self._active = torch.zeros(S, dtype=torch.float32, device=device)
            self._pool = torch.cuda.graph_pool_handle()

    def __len__(self) -> int:
        return len(self._rungs)

    def built(self, rung: int) -> bool:
        return self._built[rung]

    # ------------------------------------------------------------------
    def eager(self, rung: int, tokens, positions, active):
        """The plain step of ``rung`` on device copies of the numpy
        inputs -> f32 logits (S, V); the pool caches are written in
        place."""
        policy, sp = self._rungs[rung]
        dev = self.device
        logits, _ = self._step(
            self._params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev), self._caches, sp,
            torch.from_numpy(active).to(dev), policy=policy)
        return logits

    def build(self, rung: int) -> None:
        """Build ``rung``'s step once: on the card, one eager warm step
        and the capture of its graph."""
        if self._built[rung]:
            return
        self.builds += 1
        if self._cuda:
            self._capture(rung)
        self._built[rung] = True

    @torch.no_grad()
    def _capture(self, rung: int) -> None:
        for args in self._reserve:
            K.reserve_matmul_scratch(*args[:4], self.device, args[4])
        self._reserve = []
        policy, sp = self._rungs[rung]
        # inactive inputs: every slot writes the scratch position only
        self._tokens.zero_()
        self._positions.fill_(self._scratch_pos)
        self._active.zero_()

        def run():
            logits, _ = self._step(self._params, self._tokens,
                                   self._positions, self._caches, sp,
                                   self._active, policy=policy)
            return logits, torch.argmax(logits, -1)

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        c1 = dict(K.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            logits, nxt = run()
        c2 = dict(K.launch_counts)
        self.captured[rung] = {k: c2[k] - c1[k] for k in c1}
        # the graph writes the scratch it captured: hold it for as long
        # as the graph lives
        self.scratch[rung] = K.scratch_tensors(self.device)
        self._graphs[rung] = (graph, logits, nxt)

    # ------------------------------------------------------------------
    def __call__(self, rung: int, tokens: np.ndarray, positions: np.ndarray,
                 active: np.ndarray):
        """One decode step of ``rung`` -> (greedy tokens (S,) numpy,
        f32 logits (S, V)).  On the card the logits are the graph's
        static output, overwritten by the next replay of that rung."""
        self.build(rung)
        self.steps[rung] += 1
        if not self._cuda:
            logits = self.eager(rung, tokens, positions, active)
            return torch.argmax(logits, -1).numpy(), logits
        graph, logits, nxt = self._graphs[rung]
        self._tokens.copy_(torch.from_numpy(tokens))
        self._positions.copy_(torch.from_numpy(positions))
        self._active.copy_(torch.from_numpy(active))
        graph.replay()
        return nxt.cpu().numpy(), logits

    def launches(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The kernel launches that ran over a span whose wrapper counts
        are ``counts``, where the span holds every build and step of
        these rungs: each launch recorded while capturing a rung's graph
        ran once per replay of it, not at the capture."""
        out = dict(counts)
        for cap, n in zip(self.captured, self.steps):
            for k, v in cap.items():
                out[k] += v * (n - 1)
        return out
