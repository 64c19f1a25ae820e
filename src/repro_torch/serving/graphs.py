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
  one graph per draft length gamma; the quality monitor's shadow dense
  probe is one more, a window-1 verify (gamma 0) under the dense
  reference policy;
- :class:`ReconSteps`: the quality monitor's Eq. 6 reconstruction pass
  at ``(1, window)``, one graph for every rung (a staging sp tree);
- :class:`BatchDecodeSteps`: the static-batch loop's plain decode step
  at ``(B,)`` (``launch/serve.generate``, and the enc-dec and VLM
  families, which the engine refuses), one graph per decode policy,
  over caches of its own.

Each keeps static input buffers, filled with ``copy_`` (or ``fill_``)
before a replay; the pool caches are written in place, and the params
and sp trees are captured by address (they outlive the graphs: the
engine holds them).  A graph is captured after one eager warm call on a
side stream (library build, cuBLAS handles, allocator), with inactive
inputs that write only the pool's slack, past every position a request
can hold: a decode step the scratch position, a chunk the ``C``
positions from ``max_len``, a verify the last ``gamma + 1`` positions.
Each build then puts back what its warm call wrote (``_Steps.written``),
so a build leaves the pool as it found it.  A rolling-window leaf (a
``local`` layer) has no slack: there the decode warm call's write lands
on a live slot.  Nor has an SSM entry (a ``mamba`` layer's conv windows
and state): the decode warm call advances every slot's state, so a
decode build puts those entries back whole.  And an inactive decode row
attends its slot's slack:
in a MoE layer its expert rows join the active tokens' in each
expert's shared block selection (no token weights there, as in the
reference), so slack left by a build would change served tokens.  A
build in the middle of serving therefore changes nothing a later step
computes.  The steps never run at once, so every graph of an
engine shares one memory pool (:class:`GraphSpace`).

A capture or a replay that fails raises; nothing falls back to eager.
A CUDA graph destroyed while another is being captured invalidates
that capture, and Python destroys a graph held by a dead reference
cycle whenever its collector happens to run; so each capture first
collects such garbage and runs with the automatic collector off.
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

import gc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.unstacked import sparsifiable_leaves
from repro_torch.device import sync
from repro_torch.kernels import sparse_matmul as K
from repro_torch.kernels.ops import channel_plan
from repro_torch.models import api, moe
from repro_torch.models import params as P


class GraphSpace:
    """What an engine's captured steps share: the device, one graph
    memory pool, and the ``(B, n, m, blk, elem_bytes, experts)`` matmul
    shapes whose split-K scratch is reserved before the first capture."""

    def __init__(self, device: torch.device,
                 reserve: Sequence[Tuple[int, ...]] = ()):
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
        for B, n, m, blk, elem, experts in self._reserve:
            K.reserve_matmul_scratch(B, n, m, blk, self.device, elem,
                                     experts)
        self._reserve = []
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        c1 = dict(K.launch_counts)
        graph = torch.cuda.CUDAGraph()
        # no dead graph may be destroyed inside the capture (see the
        # module docstring)
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outs = run()
        finally:
            if was_enabled:
                gc.enable()
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
    graph's lifetime (both empty on the CPU).  ``on_build``, when set,
    is called with a key as that key's build starts (the engine's
    ``compile`` event)."""

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
        self.on_build = None

    def __len__(self) -> int:
        return len(self.keys)

    def built(self, i: int) -> bool:
        return self._built[i]

    def build(self, i: int) -> None:
        """Build step ``i`` once: on the card, one eager warm call and the
        capture of its graph, with the inactive inputs; the cache columns
        the warm call writes are put back after it."""
        if self._built[i]:
            return
        self.builds += 1
        if self.on_build is not None:
            self.on_build(self.keys[i])
        if self.space.cuda:
            self._inactive(i)
            cols = self.written(i)
            saved = [c.clone() for c in cols]
            graph, outs, self.captured[i], self.scratch[i] = \
                self.space.capture(lambda: self._run(i))
            self._graphs[i] = (graph,) + tuple(outs)
            with torch.no_grad():
                for c, kept in zip(cols, saved):
                    c.copy_(kept)
        self._built[i] = True

    def _replay(self, i: int) -> tuple:
        """Replay step ``i``'s graph (built before its inputs were
        filled: a build resets them to the inactive values)."""
        self.steps[i] += 1
        graph, *outs = self._graphs[i]
        graph.replay()
        return tuple(outs)

    def written(self, i: int) -> list:
        """Views of the pool's cache columns that step ``i`` writes on
        its inactive inputs (none by default)."""
        return []

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


def backends(policy) -> set:
    """Every backend ``policy`` runs somewhere (its default, by role or
    by depth)."""
    return ({policy.backend} | {b for _, b in policy.role_backends}
            | {b for _, _, b in policy.block_backends})


def matmul_shapes(params, blocks, rows, expert_rows=(),
                  whole_rows=None) -> list:
    """(B, n, m, blk, elem_bytes, experts) of every ``pallas`` matmul over
    the sparsifiable weights of ``params`` at each channel block of
    ``blocks``: a (reps, n, m) weight at each row count of ``rows``, a
    MoE layer's (reps, E, n, m) expert weights, launched once for all E
    experts, at each of ``expert_rows``; ``whole_rows(n, m, blk, elem,
    E)``, when given, adds a set of row counts per weight (a whole-prompt
    prefill's).  What :class:`GraphSpace` reserves before its first
    capture."""
    elem = params["embed"].element_size()
    shapes = set()
    for group in params["groups"]:
        for layer in group.values():
            for _path, w in sparsifiable_leaves(layer):
                if w.dim() == 4:                     # (reps, E, n, m)
                    E, n, m = w.shape[1:]
                    rs = set(expert_rows)
                else:                                # (reps, n, m)
                    E, n, m = 1, w.shape[1], int(np.prod(w.shape[2:]))
                    rs = set(rows)
                for block in blocks:
                    blk, n_padded, _ = channel_plan(n, block)
                    bs = rs | (whole_rows(n_padded, m, blk, elem, E)
                               if whole_rows is not None else set())
                    shapes.update((B, n_padded, m, blk, elem, E) for B in bs)
    return sorted(shapes)


def scratch_columns(caches, scratch_pos: int) -> list:
    """Views of the one time column of every cache leaf that a decode
    step with every slot inactive writes: ``scratch_pos``, or
    ``scratch_pos % T`` in a leaf of T < the pool length (a ``local``
    layer's rolling window, ``cache_write_kv(rolling=True)``).  In a full
    length leaf that column is scratch; in a rolling one it is a live
    position of every slot whose request has passed the window.  SSM
    entries have no time column (:func:`ssm_leaves`)."""
    out = []
    for group in caches:
        for entry in group:
            if "self" not in entry:
                continue
            k, v = entry["self"]["k"], entry["self"]["v"]
            T = k.shape[-1]
            c = scratch_pos % T
            out.extend((k[..., c], v[..., c, :]))
    return out


def window_columns(caches, slots: slice, start: int, length: int) -> list:
    """Views of positions ``[start, start + length)`` of the pool rows
    ``slots`` in every cache leaf (full-length leaves: the chunk and
    verify steps run on no rolling window and no SSM layer)."""
    out = []
    for group in caches:
        for entry in group:
            if "self" not in entry:
                continue
            k, v = entry["self"]["k"], entry["self"]["v"]
            out.extend((k[:, slots, ..., start:start + length],
                        v[:, slots, :, start:start + length]))
    return out


def ssm_leaves(caches) -> list:
    """Every tensor of every SSM entry (a ``mamba`` layer's conv windows
    and f32 state, all slots): a decode step with every slot inactive
    advances them all, and their reference lets inactive slots' states
    drift in its own decode step, so a build puts them back whole."""
    return [leaf for group in caches for entry in group
            for leaf in entry.get("ssm", {}).values()]


class DecodeSteps(_Steps):
    """One batched slot-decode step per rung.

    ``step`` is ``api.make_slot_decode_step(cfg)``; ``rungs`` lists each
    rung's (decode-phase policy, sp tree).  Inactive slots write
    ``scratch_pos``, and in a rolling-window leaf its slot modulo the
    window, which may hold a live request's position: the columns a
    build puts back (:func:`scratch_columns`, a few KB per layer), with
    every SSM entry whole (:func:`ssm_leaves`; 151 MB for mamba2_130m's
    24 layers at 8 slots)."""

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

    def written(self, i: int) -> list:
        return scratch_columns(self._caches, self._scratch_pos) + \
            ssm_leaves(self._caches)

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

    def written(self, i: int) -> list:
        return window_columns(self._caches, slice(0, 1), self._slack,
                              self._tokens.shape[1])

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

    def written(self, i: int) -> list:
        g1 = self.keys[i] + 1
        return window_columns(self._caches, slice(None), self._pool_len - g1,
                              g1)

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


class ReconSteps(_Steps):
    """The quality monitor's reconstruction pass at ``(1, window)``, one
    step: one dense unstacked forward collecting every block's input,
    then each block re-run under the paper's per-token ``mask`` numerics
    with the rung's per-depth sp, against the next block's dense input
    (the last block against its own dense output).  Returns the per-block
    Eq. 6 MSEs ``(L,)`` and each block input's mean ``|x|`` ``(L, d)``,
    both f32.  It writes no cache.

    Ladder rungs share one sp schema, so one step serves every rung: on
    the card the graph reads a staging copy of an sp tree, into which
    each call copies its rung's tree (a few dozen small tensors) before
    the replay.  One capture, whatever the ladder's length, where a graph
    per rung would add one capture (and its memory) per rung."""

    def __init__(self, cfg, params, sp, window: int, space: GraphSpace):
        from repro_torch.core import unstacked as U
        from repro_torch.sparsity import SparsityPolicy
        super().__init__([0], space)
        self._cfg = cfg
        self._params = params
        self._layers = U.unstack_layers(cfg, params)
        self._mask = SparsityPolicy.uniform("mask")
        self.window = window
        if space.cuda:
            self._tokens = torch.zeros((1, window), dtype=torch.long,
                                       device=space.device)
            self._sp = P.tree_map(torch.clone, sp)

    def _eager(self, tokens, sp):
        from repro_torch.models import model as M
        from repro_torch.obs.quality import unstack_sp
        cfg, layers = self._cfg, self._layers
        per_depth = unstack_sp(cfg, sp)
        x = M.embed_tokens(self._params, tokens, cfg)
        block_io = []
        for dl in layers:
            block_io.append(x)
            x, _ = M.layer_apply(dl.params, x, cfg, dl.kind, None, None,
                                 None, "train")
        refs = block_io[1:] + [x]
        errs, feats = [], []
        for d, dl in enumerate(layers):
            x_in = block_io[d]
            y, _ = M.layer_apply(dl.params, x_in, cfg, dl.kind,
                                 per_depth[d], None, None, "train",
                                 policy=self._mask.resolve_depth(d))
            errs.append(torch.mean(torch.square(y.float()
                                                - refs[d].float())))
            feats.append(torch.mean(torch.abs(x_in.float()), dim=(0, 1)))
        return torch.stack(errs), torch.stack(feats)

    def _inactive(self, i: int) -> None:
        self._tokens.zero_()

    def _run(self, i: int) -> tuple:
        return self._eager(self._tokens, self._sp)

    def __call__(self, tokens: np.ndarray, sp):
        """The pass over ``tokens`` ``(1, window)`` under the sp tree
        ``sp`` -> (errs (L,), feats (L, d)) on the device; on the card
        the graph's static outputs, overwritten by its next replay."""
        self.build(0)
        if not self.space.cuda:
            self.steps[0] += 1
            return self._eager(torch.from_numpy(tokens).to(self.device), sp)
        self._tokens.copy_(torch.from_numpy(tokens))
        _tree_copy_(self._sp, sp)
        return self._replay(0)


class BatchDecodeSteps(_Steps):
    """The static-batch loop's decode step (the reference's jitted
    ``decode`` in ``launch/serve.generate``): ``api.make_decode_step``
    at ``(batch,)`` tokens, every row at one position, one step per key
    of ``policies``, each a (decode-phase policy, sp tree).

    The steps own ``caches``, zeros of ``api.init_caches(cfg, batch,
    total_len)``'s shapes (an enc-dec model's static cross cache of
    ``encoder_frames`` rows too): a step is built on them before a
    prompt's padded caches are copied in (:meth:`decode`), so neither
    the warm call nor the capture sees a live cache.  The inactive
    inputs put every row at ``total_len - 1``, the one position a
    ``gen``-token loop from a prompt of ``total_len - gen`` never writes;
    a build on filled caches still puts back what its warm call wrote
    there (:func:`scratch_columns`: on a ``local`` layer that column is
    ``total_len - 1`` modulo the window; :func:`ssm_leaves`, which every
    decode step advances).  The split-K scratch of every ``pallas``
    matmul at ``batch`` rows is reserved before the first capture.

    The graph returns the f32 logits (B, V) and their argmax, as
    :class:`DecodeSteps` does.  On the CPU the steps run eagerly."""

    def __init__(self, cfg, params, policies: Sequence[tuple], batch: int,
                 total_len: int, device):
        policies = list(policies)
        device = torch.device(device)
        blocks = {pol.block for pol, _ in policies
                  if "pallas" in backends(pol)}
        reserve = matmul_shapes(
            params, blocks, {batch},
            {moe.expert_rows(cfg, batch, 1)} if cfg.num_experts else ()
        ) if device.type == "cuda" else ()
        super().__init__(range(len(policies)), GraphSpace(device, reserve))
        self._step = api.make_decode_step(cfg)
        self._params = params
        self._policies = policies
        self.batch, self.total_len = batch, total_len
        self.caches = api.init_caches(cfg, batch, total_len, device)
        self._scratch_pos = total_len - 1
        if self.space.cuda:
            self._tokens = torch.zeros(batch, dtype=torch.long,
                                       device=device)
            self._positions = torch.full((batch,), self._scratch_pos,
                                         dtype=torch.long, device=device)

    def _eager(self, i: int, tokens, positions):
        policy, sp = self._policies[i]
        logits, _ = self._step(self._params, {
            "tokens": tokens, "positions": positions,
            "caches": self.caches}, sp, policy=policy)
        return logits

    def _inactive(self, i: int) -> None:
        self._tokens.zero_()
        self._positions.fill_(self._scratch_pos)

    def _run(self, i: int) -> tuple:
        logits = self._eager(i, self._tokens, self._positions)
        return logits, torch.argmax(logits, -1)

    def written(self, i: int) -> list:
        return scratch_columns(self.caches, self._scratch_pos) + \
            ssm_leaves(self.caches)

    @torch.no_grad()
    def decode(self, i: int, caches, first: torch.Tensor, start: int,
               gen: int, times: Optional[list] = None) -> torch.Tensor:
        """The loop of ``generate``: ``caches`` (padded to ``total_len``
        positions, ``api.pad_caches``) copied into the owned ones, then
        ``gen - 1`` steps of key ``i`` from the prefill's tokens
        ``first`` (B,), step ``j`` at position ``start + j`` ->
        (B, ``gen``) greedy tokens on the device, with no host read (on
        the card each step a replay of the graph, fed the previous
        step's argmax).  ``times``, a list, gets each step's host ms,
        the device synced after each step for that reading only."""
        self.build(i)
        _tree_copy_(self.caches, caches)
        out = torch.empty((self.batch, gen), dtype=torch.long,
                          device=self.device)
        out[:, 0] = first
        tok = out[:, 0]
        for j in range(gen - 1):
            t0 = obs.now()
            if self.space.cuda:
                self._tokens.copy_(tok)
                self._positions.fill_(start + j)
                _, tok = self._replay(i)
            else:
                self.steps[i] += 1
                tok = torch.argmax(self._eager(i, tok, torch.full(
                    (self.batch,), start + j, dtype=torch.long)), -1)
            out[:, j + 1] = tok
            if times is not None:
                sync(self.device)
                times.append(1e3 * (obs.now() - t0))
        return out


def _tree_copy_(dst, src) -> None:
    """Copy every leaf of ``src`` into ``dst``'s leaf at the same path."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _tree_copy_(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _tree_copy_(a, b)
    else:
        dst.copy_(src)
