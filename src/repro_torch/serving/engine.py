"""Continuous-batching inference engine (port of the core of the JAX
package's ``serving/engine.py``).

One engine owns the slot KV pool, the FIFO scheduler and the phase steps.
Sparsity is phase-aware per the paper's §5.1 recipe: prefill chunks that
start in the first ``prefill_dense_frac`` of the prompt run dense, later
chunks and every decode step run under the configured
:class:`SparsityPolicy` (``policy.for_phase``).  Decode runs batched over
the whole slot pool with the active-slot mask as the token weights of
the shared saliency; inactive slots write their garbage K/V at a scratch
position past every reachable one.

Prefill strategies: ``"chunked"`` (fixed-size chunks written straight
into the pool slot) and ``"whole"`` (one whole-prompt forward, batched
over same-length prompts, then inserted into the pool); ``"auto"``
resolves to chunked for the dense-attention archs the port serves.

Adaptive serving: instead of one policy the engine can serve a
:class:`repro_torch.sparsity.PolicyLadder` — calibrated policies at
ascending sparsity budgets.  With an :class:`SLOConfig` an
:class:`AdaptiveController` switches the decode and prefill-sparse
phases between rungs as load changes.

Every step is built once (``repro_torch.serving.graphs``: a CUDA graph
on the card): each rung's decode step, each rung's chunked-prefill step
per prefill phase policy, and under speculative decoding the verify for
every reachable gamma.  :meth:`Engine.warmup` builds them all (it runs
at construction when a controller or speculative decoding is armed);
otherwise a step is built at its first use, writing only the pool's
slack.  A rung or gamma switch only selects another graph;
``decode_retraces_after_warmup``, ``chunk_retraces_after_warmup`` and
``verify_retraces_after_warmup`` count builds after warmup, as the
reference counts retraces.

Speculative decoding (``EngineConfig.spec``, a ladder required): the
decode action runs :class:`repro_torch.serving.spec.SpecDecoder`, in
which sparse rungs draft and the dense verifier rung verifies; the
output is token-identical to verifier-only decode.

The reference's prefix cache, preemption and priority scheduling,
telemetry, flight recorder and quality probes (and the controller's
``priority_aware``/``quality_aware`` modes, which read them) are not
ported yet: asking for any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, sync
from repro_torch.core.unstacked import sparsifiable_leaves
from repro_torch.kernels.ops import channel_plan
from repro_torch.models import api
from repro_torch.models import model as M
from repro_torch.serving.controller import AdaptiveController, SLOConfig
from repro_torch.serving import graphs
from repro_torch.serving.graphs import ChunkSteps, DecodeSteps, GraphSpace
from repro_torch.serving.kv_pool import SlotKVPool
from repro_torch.serving.metrics import EngineStats
from repro_torch.serving.request import (FinishReason, Request, RequestState,
                                         Status)
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.spec import SpecConfig, SpecDecoder
from repro_torch.sparsity import PolicyLadder, SparsityPolicy

_NOT_PORTED = ("prefix_cache", "scheduler")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``policy`` is the engine's execution policy (``None`` = dense).
    Ladder serving ignores it: the rung policies come from the ladder
    passed to :class:`Engine`.

    ``slo`` enables the adaptive controller (requires a ladder);
    ``initial_rung`` is the rung a ladder engine starts on (and stays on
    when no SLO is configured — a pinned rung).  ``spec`` arms
    self-speculative decoding (requires a ladder: sparse rungs draft, the
    dense verifier rung verifies; see :mod:`repro_torch.serving.spec`).
    ``prefix_cache`` and ``scheduler`` keep the reference's names and
    raise ``NotImplementedError`` when set, as do the SLO's
    ``priority_aware`` and ``quality_aware`` modes."""
    max_slots: int = 8
    max_len: int = 512
    prefill_chunk: int = 32
    policy: Optional[SparsityPolicy] = None
    prefill_dense_frac: float = 0.5  # §5.1: first fraction of prompt dense
    prefill_strategy: str = "auto"   # auto|chunked|whole
    eos_id: Optional[int] = None     # default per-request EOS
    slo: Optional[SLOConfig] = None  # adaptive serving objectives
    initial_rung: int = 0            # ladder rung at engine start
    spec: Optional[SpecConfig] = None  # self-speculative decoding
    prefix_cache: bool = False
    scheduler: object = None

    def __post_init__(self):
        pol = self.policy
        if pol is None:
            pol = SparsityPolicy.dense()
        elif not isinstance(pol, SparsityPolicy):
            raise TypeError(
                f"policy must be a SparsityPolicy, got {type(pol)!r}")
        object.__setattr__(self, "policy", pol)
        if self.spec is not None and not isinstance(self.spec, SpecConfig):
            raise TypeError(
                f"spec must be a SpecConfig, got {type(self.spec)!r}")
        if self.slo is not None:
            if not isinstance(self.slo, SLOConfig):
                raise TypeError(
                    f"slo must be an SLOConfig, got {type(self.slo)!r}")
            for mode, needs in (("priority_aware", "the priority scheduler"),
                                ("quality_aware", "the quality monitor")):
                if getattr(self.slo, mode):
                    raise NotImplementedError(
                        f"SLOConfig.{mode} needs {needs}, which is not "
                        "ported yet (see ROADMAP.md queue 1)")
        if self.initial_rung < 0:
            raise ValueError(
                f"initial_rung must be >= 0, got {self.initial_rung}")
        for name in _NOT_PORTED:
            if getattr(self, name):
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet (see ROADMAP.md "
                    "queue 1)")
        if not 0 <= self.prefill_dense_frac <= 1:
            raise ValueError(
                f"prefill_dense_frac must be in [0, 1], "
                f"got {self.prefill_dense_frac}")
        if self.prefill_strategy not in ("auto", "chunked", "whole"):
            raise ValueError(
                f"unknown prefill_strategy {self.prefill_strategy!r}")
        for name in ("max_slots", "max_len", "prefill_chunk"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")


class Engine:
    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 sp=None, *, device="cuda",
                 ladder: Optional[PolicyLadder] = None, telemetry=None):
        if telemetry is not None:
            raise NotImplementedError(
                "telemetry is not ported yet (see ROADMAP.md queue 1)")
        M.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.ladder = ladder
        if ladder is not None:
            if not isinstance(ladder, PolicyLadder):
                raise TypeError(
                    f"ladder must be a PolicyLadder, got {type(ladder)!r}")
            if sp is not None:
                raise ValueError(
                    "pass either a ladder (which carries per-rung sp "
                    "trees) or a flat sp tree, not both")
            if not 0 <= ecfg.initial_rung < len(ladder):
                raise ValueError(
                    f"initial_rung {ecfg.initial_rung} outside the "
                    f"{len(ladder)}-rung ladder")
            self._rung_policies = list(ladder.policies)
            self._rung_sp = list(ladder.sps)
        else:
            if ecfg.slo is not None:
                raise ValueError(
                    "EngineConfig.slo needs a PolicyLadder: the controller "
                    "switches rungs, a single policy has none")
            if ecfg.initial_rung != 0:
                raise ValueError(
                    f"initial_rung={ecfg.initial_rung} needs a "
                    "PolicyLadder; a fixed-policy engine has only rung 0")
            self._rung_policies = [ecfg.policy]
            self._rung_sp = [sp]
        # per-rung per-phase policies, derived once
        self._rung_phases = [
            (pol.for_phase("prefill_dense"), pol.for_phase("prefill_sparse"),
             pol.for_phase("decode")) for pol in self._rung_policies]
        self._rung = ecfg.initial_rung if ladder is not None else 0
        self.controller = None
        if ecfg.slo is not None:
            self.controller = AdaptiveController(
                len(self._rung_policies), ecfg.slo, initial_rung=self._rung)
        if ecfg.spec is not None:
            self._check_spec(ecfg)
        # the pool holds slack past max_len: pad tokens of a request's
        # final prefill chunk land in [max_len, pool_len-1), and the last
        # position is scratch — inactive slots in a decode step still
        # write somewhere, and every real position may belong to a
        # mid-prefill prompt.  Scratch is beyond every reachable position,
        # so the decode valid-mask never admits it.  Spec decoding needs
        # the slack to also fit a (gamma+1)-token verify window
        # (inactive-slot windows and draft overshoot past a request's
        # budget both land there).
        slack = ecfg.prefill_chunk
        if ecfg.spec is not None:
            slack = max(slack, ecfg.spec.max_gamma + 1)
        self.pool_len = ecfg.max_len + slack
        self.pool = SlotKVPool(cfg, ecfg.max_slots, self.pool_len,
                               self.device)
        self.scheduler = Scheduler()
        self.stats = EngineStats()
        self.states: Dict[int, RequestState] = {}
        self._next_id = 0
        self.prefill_strategy = ("chunked" if ecfg.prefill_strategy == "auto"
                                 else ecfg.prefill_strategy)
        self._pstep = api.make_prefill_step(cfg)
        self.graph_space = GraphSpace(self.device, self._scratch_shapes())
        self._decode = DecodeSteps(
            api.make_slot_decode_step(cfg), params, self.pool.caches,
            [(dec, s) for (_, _, dec), s in zip(self._rung_phases,
                                                self._rung_sp)],
            ecfg.max_slots, self.pool_len - 1, self.graph_space)
        # a chunk's inactive inputs write [max_len, max_len + C): slack
        self._chunk = ChunkSteps(
            api.make_chunk_prefill_step(cfg), params, self.pool.caches,
            [(pd, ps, s) for (pd, ps, _), s in zip(self._rung_phases,
                                                   self._rung_sp)],
            ecfg.prefill_chunk, ecfg.max_len, self.graph_space)
        self._warm_builds: Optional[tuple] = None
        self.spec_decoder: Optional[SpecDecoder] = None
        if ecfg.spec is not None:
            self.spec_decoder = SpecDecoder(self, ecfg.spec)
        if self.controller is not None or self.spec_decoder is not None:
            self.warmup()

    def _check_spec(self, ecfg: EngineConfig) -> None:
        """The reference's preconditions of speculative decoding."""
        spec = ecfg.spec
        if self.ladder is None:
            raise ValueError(
                "EngineConfig.spec needs a PolicyLadder: the drafter "
                "and verifier are ladder rungs")
        if ecfg.slo is not None:
            raise ValueError(
                "spec and slo are mutually exclusive: the spec "
                "controller adapts gamma/drafter from acceptance, and "
                "the verifier rung is pinned")
        if spec.drafter_rung >= len(self.ladder):
            raise ValueError(
                f"drafter_rung {spec.drafter_rung} outside the "
                f"{len(self.ladder)}-rung ladder")
        if ecfg.initial_rung != spec.verifier_rung:
            raise ValueError(
                "a spec engine serves at the verifier rung; set "
                f"initial_rung == verifier_rung ({spec.verifier_rung})")
        ver_pol = self._rung_phases[spec.verifier_rung][2]
        if not ver_pol.is_dense:
            raise ValueError(
                f"verifier rung {spec.verifier_rung} decodes "
                "under a sparse policy; the token-parity guarantee "
                "needs a dense verifier — shared top-k saliency "
                "depends on the call's token rows, so a multi-token "
                "verify forward and single-token decode would pick "
                "different channel sets and diverge")

    def _scratch_shapes(self) -> List[tuple]:
        """(B, n, m, blk, elem_bytes) of every ``pallas`` matmul the
        engine can launch before or after a capture: each sparsifiable
        weight at B = max_slots (decode) and, for chunked prefill, at
        B = prefill_chunk (a chunk's token rows)."""
        blocks = {pol.block for pol in self._rung_policies
                  if "pallas" in _backends(pol)}
        if not blocks or self.device.type != "cuda":
            return []
        rows = {self.ecfg.max_slots}
        if self.prefill_strategy == "chunked":
            rows.add(self.ecfg.prefill_chunk)
        elem = self.params["embed"].element_size()
        shapes = set()
        for group in self.params["groups"]:
            for layer in group.values():
                for _path, w in sparsifiable_leaves(layer):  # (reps, n, m)
                    n, m = w.shape[1], int(np.prod(w.shape[2:]))
                    for block in blocks:
                        blk, n_padded, _ = channel_plan(n, block)
                        shapes.update((B, n_padded, m, blk, elem)
                                      for B in rows)
        return sorted(shapes)

    # ------------------------------------------------------------------
    # ladder rungs
    # ------------------------------------------------------------------
    @property
    def rung(self) -> int:
        return self._rung

    @property
    def num_rungs(self) -> int:
        return len(self._rung_policies)

    @property
    def policy(self) -> SparsityPolicy:
        """The currently active rung's policy."""
        return self._rung_policies[self._rung]

    @property
    def sp(self):
        return self._rung_sp[self._rung]

    def set_rung(self, i: int) -> None:
        if not 0 <= i < self.num_rungs:
            raise ValueError(f"rung {i} outside [0, {self.num_rungs})")
        self._rung = i

    @torch.no_grad()
    def warmup(self) -> None:
        """Build every rung's decode step and, for chunked prefill, its
        chunk step per prefill phase policy, plus under spec decoding
        the verify for every reachable gamma (on the card: one eager warm
        call and one CUDA-graph capture each), then zero the post-warmup
        build baseline.  Only valid on an idle engine, as in the
        reference.  Rung and gamma switches after this build nothing
        (the ``*_retraces_after_warmup`` stay 0)."""
        if self.scheduler.has_work() or self.pool.num_occupied:
            raise RuntimeError(
                "warmup() on a busy engine would corrupt live KV state; "
                "call it before submitting requests")
        for r in range(self.num_rungs):
            self._decode.build(r)
        if self.prefill_strategy == "chunked":
            for i in range(len(self._chunk)):
                self._chunk.build(i)
        if self.spec_decoder is not None:
            vs = self.spec_decoder.verify_steps   # one step per gamma
            for i in range(len(vs)):
                vs.build(i)
        sync(self.device)
        self._warm_builds = tuple(0 if s is None else s.builds
                                  for s in self._step_kinds())

    def _step_kinds(self) -> tuple:
        """(decode, chunk, verify) steps; verify is None without spec."""
        return (self._decode, self._chunk,
                None if self.spec_decoder is None
                else self.spec_decoder.verify_steps)

    def _retraces(self, kind: int) -> Optional[int]:
        steps = self._step_kinds()[kind]
        if self._warm_builds is None or steps is None:
            return None
        return steps.builds - self._warm_builds[kind]

    @property
    def decode_retraces_after_warmup(self) -> Optional[int]:
        """Decode-step builds since :meth:`warmup` (captures on the
        card); None before warmup.  Stays 0 however often the controller
        switches rungs (draft steps included: they replay the drafter
        rung's decode step)."""
        return self._retraces(0)

    @property
    def chunk_retraces_after_warmup(self) -> Optional[int]:
        """Chunk-step builds since :meth:`warmup`; None before warmup.
        Stays 0 across rung switches."""
        return self._retraces(1)

    @property
    def verify_retraces_after_warmup(self) -> Optional[int]:
        """Verify builds since :meth:`warmup`; None before warmup or
        without spec decoding.  Stays 0 across gamma switches: every
        reachable gamma's verify is built at warmup."""
        return self._retraces(2)

    @property
    def decode_graphs(self) -> DecodeSteps:
        """The per-rung decode steps: builds, steps (replays on the
        card) and the kernel launches recorded in each capture."""
        return self._decode

    @property
    def chunk_graphs(self) -> ChunkSteps:
        """The chunk steps, one per (rung, prefill phase policy)."""
        return self._chunk

    def launches(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The kernel launches that ran over a span whose wrapper counts
        are ``counts``, where the span holds every build and step of this
        engine: each launch recorded in a capture taken once per replay
        (:func:`repro_torch.serving.graphs.launches`)."""
        return graphs.launches(counts, *(s for s in self._step_kinds()
                                         if s is not None))

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None,
               arrival_time: Optional[float] = None) -> RequestState:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or prompt.size >= self.ecfg.max_len:
            raise ValueError(
                f"prompt length {prompt.size} outside (0, {self.ecfg.max_len})")
        max_new = min(max_new_tokens, self.ecfg.max_len - prompt.size)
        req = Request(self._next_id, prompt, max_new,
                      eos_id if eos_id is not None else self.ecfg.eos_id,
                      obs.now() if arrival_time is None else arrival_time)
        self._next_id += 1
        rs = RequestState(req)
        self.states[req.request_id] = rs
        self.scheduler.enqueue(rs)
        self.stats.submitted += 1
        return rs

    @torch.no_grad()
    def step(self) -> str:
        """Admit queued requests into free slots, then run one
        scheduler-chosen phase step."""
        self._admit()
        self.stats.sample(self.scheduler.queue_depth, self.pool.num_occupied)
        action = self.scheduler.next_action()
        if action == "prefill":
            if self.prefill_strategy == "chunked":
                self._prefill_chunk(self.scheduler.prefill_head())
            else:
                self._prefill_whole(self.scheduler.prefill_group())
        elif action == "decode":
            if self.spec_decoder is not None:
                self.spec_decoder.step()
            else:
                self._decode_step()
        return action

    def run(self) -> Dict[int, List[int]]:
        """Drive until idle; returns {request_id: generated tokens}."""
        while self.scheduler.has_work():
            self.step()
        return {rid: rs.tokens for rid, rs in self.states.items()}

    def _admit(self) -> None:
        sched = self.scheduler
        while sched.has_queued() and self.pool.num_free:
            rs = sched.pop_admit()
            rs.slot = self.pool.alloc()
            rs.status = Status.PREFILL
            sched.prefilling.append(rs)

    # ------------------------------------------------------------------
    def _phase_policy(self, offset: int, prompt_len: int) -> SparsityPolicy:
        """§5.1: chunks starting before the dense boundary run dense."""
        pd, ps, _ = self._rung_phases[self._rung]
        dense_end = int(np.ceil(prompt_len * self.ecfg.prefill_dense_frac))
        return pd if offset < dense_end else ps

    def _emit(self, rs: RequestState, token: int) -> None:
        rs.emit(token)
        if self.ladder is not None:
            rs.token_rungs.append(self._rung)
        self.stats.decode_tokens += 1

    def _prefill_chunk(self, rs: RequestState) -> None:
        C = self.ecfg.prefill_chunk
        req = rs.request
        off = rs.next_offset
        real = min(C, req.prompt_len - off)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :real] = req.prompt[off:off + real]
        weights = np.zeros((C,), np.float32)
        weights[:real] = 1.0
        policy = self._phase_policy(off, req.prompt_len)
        i = self._chunk.index(self._rung, policy)
        # a step not built yet (no warmup) builds outside the timed step
        self._chunk.build(i)
        t0 = obs.now()
        logits = self._chunk(i, chunk, off, rs.slot, weights)
        sync(self.device)
        t1 = obs.now()
        dt = t1 - t0
        self.stats.prefill_time += dt
        self.stats.prefill_step_s.append(dt)
        self.stats.prefill_chunks += 1
        self.stats.prefill_sparse_chunks += int(not policy.is_dense)
        self.stats.prefill_tokens += real
        rs.next_offset = off + real
        self.pool.lengths[rs.slot] = rs.next_offset
        if rs.done_prefill:
            first = int(torch.argmax(logits[0, real - 1]))
            self._start_decode(rs, first)

    def _prefill_whole(self, group: List[RequestState]) -> None:
        P = group[0].request.prompt_len
        tokens = np.stack([rs.request.prompt for rs in group]).astype(np.int64)
        # whole-prompt prefill can't split tokens by phase: any dense
        # fraction > 0 makes the whole prompt dense
        pd, ps, _ = self._rung_phases[self._rung]
        policy = ps if self.ecfg.prefill_dense_frac <= 0.0 else pd
        t0 = obs.now()
        logits, caches = self._pstep(
            self.params, torch.from_numpy(tokens).to(self.device), self.sp,
            policy=policy)
        sync(self.device)
        t1 = obs.now()
        dt = t1 - t0
        self.stats.prefill_time += dt
        self.stats.prefill_step_s.append(dt)
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += P * len(group)
        first = torch.argmax(logits, -1).cpu().numpy()
        for b, rs in enumerate(group):
            self.pool.insert(caches, b, rs.slot, P)
            rs.next_offset = P
            self._start_decode(rs, int(first[b]))

    def _start_decode(self, rs: RequestState, first_token: int) -> None:
        rs.first_token_time = obs.now()
        rs.last_token_time = rs.first_token_time
        self.stats.ttft_s.append(rs.first_token_time - rs.request.arrival_time)
        self._emit(rs, first_token)
        self.scheduler.to_decode(rs)
        self._maybe_finish(rs, first_token)

    def decode_inputs(self):
        """The next decode step's host inputs: (tokens, positions, active)
        over the whole slot pool."""
        S = self.ecfg.max_slots
        tokens = np.zeros((S,), np.int64)
        # inactive slots write their garbage token at the scratch position
        # (see pool_len above); their logits are ignored host-side and
        # their saliency weight is zero
        positions = np.full((S,), self.pool_len - 1, np.int64)
        active = np.zeros((S,), np.float32)
        for slot, rs in self.scheduler.decoding.items():
            tokens[slot] = rs.last_token
            positions[slot] = rs.position
            active[slot] = 1.0
        return tokens, positions, active

    def _decode_step(self) -> None:
        tokens, positions, active = self.decode_inputs()
        decoding = self.scheduler.decoding
        # a rung not built yet (no warmup) builds outside the timed step
        self._decode.build(self._rung)
        t0 = obs.now()
        nxt, _ = self._decode(self._rung, tokens, positions, active)
        t1 = obs.now()
        self.stats.decode_time += t1 - t0
        self.stats.decode_step_s.append(t1 - t0)
        self.stats.decode_steps += 1
        gaps = []
        for slot, rs in list(decoding.items()):
            tok = int(nxt[slot])
            if rs.last_token_time is not None:
                gaps.append(t1 - rs.last_token_time)
                self.stats.tpot_s.append(gaps[-1])
            rs.last_token_time = t1
            self._emit(rs, tok)
            self.pool.commit(slot, 1)
            self._maybe_finish(rs, tok)
        if self.controller is not None:
            new_rung = self.controller.update(
                gaps, queue_depth=self.scheduler.queue_depth,
                occupancy=self.pool.num_occupied)
            if new_rung != self._rung:
                self.set_rung(new_rung)

    def _maybe_finish(self, rs: RequestState, token: int) -> None:
        req = rs.request
        if req.eos_id is not None and token == req.eos_id:
            rs.finish_reason = FinishReason.EOS
        elif len(rs.tokens) >= req.max_new_tokens:
            rs.finish_reason = FinishReason.MAX_TOKENS
        else:
            return
        rs.finish_time = obs.now()
        self.scheduler.finish(rs)
        self.pool.free(rs.slot)
        self.stats.finished += 1


def _backends(pol: SparsityPolicy) -> set:
    return ({pol.backend} | {b for _, b in pol.role_backends}
            | {b for _, _, b in pol.block_backends})
