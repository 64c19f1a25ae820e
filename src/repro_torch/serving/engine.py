"""Continuous-batching inference engine (port of the core of the JAX
package's ``serving/engine.py``).

One engine owns the slot KV pool, the priority scheduler and the phase
steps.
Sparsity is phase-aware per the paper's §5.1 recipe: prefill chunks that
start in the first ``prefill_dense_frac`` of the prompt run dense, later
chunks and every decode step run under the configured
:class:`SparsityPolicy` (``policy.for_phase``).  Decode runs batched over
the whole slot pool with the active-slot mask as the token weights of
the shared saliency; inactive slots write their garbage K/V at a scratch
position past every reachable one.

Prefill strategies: ``"chunked"`` (fixed-size chunks written straight
into the pool slot) and ``"whole"`` (one whole-prompt forward, batched
over same-length prompts, then inserted into the pool: rolled into the
window on ``local`` layers).  ``"auto"`` resolves as the reference does:
chunked when every mixer is ``attn`` or ``global``, whole otherwise
(gemma2_2b and gemma3_4b, whose ``local`` layers keep rolling-window
caches, and mamba2_130m and the jamba hybrid, whose ``mamba`` layers
keep a conv window and an SSM state with no time axis).  Chunked
prefill, speculative decoding, the prefix cache, preemption and the
quality probe need full-length caches, and are refused on a
whole-strategy arch with the reference's exception types.
Whole-prompt prefill runs eagerly (the reference compiles it per prompt
length); its kernel launches count once each in the wrappers' counts.

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

Prefix caching (``EngineConfig.prefix_cache``): completed prefills are
published into a radix tree over prompt token ids
(``repro_torch.serving.prefix_cache``), and an admission that shares a
cached prefix copies it into its slot and chunk-prefills only the
un-cached suffix.  Requires chunked prefill and *prefix-deterministic*
prefill policies (validated at construction: dense or per-token
``mask``, identical across rungs and prompt lengths), which is what
makes a cache-hit generation bit-identical to cold prefill.

Admission control and preemption (``EngineConfig.scheduler``): a
bounded admission queue (``submit`` raises
:class:`repro_torch.serving.scheduler.QueueFull` with a retry
estimate), per-request queue-wait deadlines (``FinishReason.EXPIRED``),
strict-priority + per-tenant-WFQ admission order, and — with
``SchedulerConfig.preemption`` — suspension of a strictly less
important decoding victim to host memory (``SlotKVPool.suspend``/
``resume``) so an interactive arrival gets its slot now.  Preemption
happens only at the admission boundary, where every slot's KV length
equals its request's committed position (spec rounds commit and roll
back entirely inside their step), so a resumed request's remaining
generation is bit-identical to an unpreempted run.  Segment copies (a
hit, a publish, a suspend, a resume) are ``copy_`` into or out of the
pool tensors, which keep their addresses: the captured graphs go on
reading them, and nothing is built after warmup.

Telemetry: ``Engine(..., telemetry=repro_torch.obs.Telemetry(...))``
arms per-request span tracing (Chrome trace JSON), the structured event
log (rung switches with controller reasons, gamma changes, prefix
evictions, KV rollbacks, admission and preemption decisions, and one
``compile`` record per graph build, flagged ``after_warmup``) and
per-dispatch profiler ranges, at the reference's emit sites.  Telemetry
only *observes* host-side state — tokens are identical with it on or
off — and the default ``NULL_TELEMETRY`` costs nothing: every emit site
is an ``is not None`` check and ``annotate()`` returns a shared null
context.  :meth:`Engine.snapshot`, :meth:`Engine.metrics_exposition`
and the request hooks (``submit(..., on_token=, on_finish=)``) are what
the gateway (``repro_torch.serving.gateway``) serves from;
:meth:`Engine.close` (or the context manager) flushes every sink.

Quality probes: ``Telemetry(quality=QualityMonitor(...))`` arms live
sparsity-quality observability (``repro_torch.obs.quality``): sampled
shadow dense probes (run *before* the real decode step, so served tokens
are unchanged), online Eq. 6 reconstruction error, saliency drift and
per-rung roofline counters.  Its probe and recon steps are built at
warmup (``probe_retraces_after_warmup`` stays 0), and with
``SLOConfig.quality_aware`` the controller reads the drift pressure as a
de-escalation hint.

Injected clock and flight recorder: every engine time read goes through
``Engine(..., clock=...)`` (default the shared
:data:`repro_torch.obs.SYSTEM_CLOCK`) with a call-site tag
(:meth:`Engine._now`).  ``Telemetry(flight=FlightRecorder(...))`` wraps
that clock and records submissions, clock reads, runtime decisions and
finishes (``repro_torch.obs.flight``), from which
``repro_torch.obs.flight.replay`` re-drives a fresh engine bit for bit.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs import NULL_TELEMETRY, Telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, sync
from repro_torch.kernels import sparse_matmul as K
from repro_torch.models import api
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serving.controller import AdaptiveController, SLOConfig
from repro_torch.serving import graphs
from repro_torch.serving.graphs import ChunkSteps, DecodeSteps, GraphSpace
from repro_torch.serving.kv_pool import SlotKVPool
from repro_torch.serving.metrics import EngineStats
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import (FinishReason, Priority, Request,
                                         RequestState, Status)
from repro_torch.serving.scheduler import (QueueFull, Scheduler,
                                           SchedulerConfig)
from repro_torch.serving.spec import SpecConfig, SpecDecoder
from repro_torch.sparsity import PolicyLadder, SparsityPolicy

# Engine.snapshot() JSONL format version: the reference's v7 record (the
# quality fields when a QualityMonitor is armed, the flight fields when a
# FlightRecorder is; "t" is an out-of-band read, never part of a flight
# recording's clock stream).
SNAPSHOT_SCHEMA_VERSION = 7


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

    ``prefix_cache`` arms radix-tree KV prefix reuse
    (:mod:`repro_torch.serving.prefix_cache`): completed prefills publish
    into the tree, admissions sharing a cached prefix skip straight to
    the un-cached suffix.  ``prefix_cache_tokens`` bounds the cached
    physical tokens (0 = unbounded; LRU eviction of unpinned leaves).
    Needs chunked prefill and prefix-deterministic prefill policies,
    validated at engine construction.  ``scheduler`` arms admission
    control and preemption (None = unbounded FIFO-equivalent defaults)."""
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
    prefix_cache: bool = False       # radix-tree KV prefix reuse
    prefix_cache_tokens: int = 0     # cached-token budget (0 = unbounded)
    scheduler: Optional[SchedulerConfig] = None  # admission + preemption

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
        if self.scheduler is not None and not isinstance(
                self.scheduler, SchedulerConfig):
            raise TypeError(
                f"scheduler must be a SchedulerConfig, "
                f"got {type(self.scheduler)!r}")
        if self.initial_rung < 0:
            raise ValueError(
                f"initial_rung must be >= 0, got {self.initial_rung}")
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
        if self.prefix_cache_tokens < 0:
            raise ValueError(
                f"prefix_cache_tokens must be >= 0, "
                f"got {self.prefix_cache_tokens}")
        if self.prefix_cache and self.prefill_strategy == "whole":
            raise ValueError(
                "prefix_cache needs chunked prefill: whole-prompt "
                "prefill cannot start at a matched prefix length")

    @property
    def pool_len(self) -> int:
        """The slot pool's length: slack past ``max_len``.  Pad tokens of
        a request's final prefill chunk land in [max_len, pool_len-1),
        and the last position is scratch: inactive slots in a decode step
        still write somewhere, and every real position may belong to a
        mid-prefill prompt.  Scratch is beyond every reachable position,
        so the decode valid-mask never admits it.  Spec decoding needs
        the slack to also fit a (gamma+1)-token verify window
        (inactive-slot windows and draft overshoot past a request's
        budget both land there)."""
        slack = self.prefill_chunk
        if self.spec is not None:
            slack = max(slack, self.spec.max_gamma + 1)
        return self.max_len + slack


class Engine:
    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 sp=None, *, device="cuda",
                 ladder: Optional[PolicyLadder] = None,
                 telemetry: Telemetry = NULL_TELEMETRY, clock=None):
        if cfg.family in M.MULTIMODAL:
            raise NotImplementedError(
                f"serving engine supports token-only models, not {cfg.family}")
        if telemetry is None:
            telemetry = NULL_TELEMETRY
        elif not isinstance(telemetry, Telemetry):
            raise TypeError(
                f"telemetry must be a repro_torch.obs.Telemetry, "
                f"got {type(telemetry)!r}")
        self.obs = telemetry
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
        # injected clock: every engine time read goes through
        # self.clock.now(site).  The default is the shared SYSTEM_CLOCK
        # singleton; a flight recorder wraps it so each observation is
        # captured, and replay substitutes a ReplayClock
        if clock is None:
            clock = obs.SYSTEM_CLOCK
        elif not hasattr(clock, "now"):
            raise TypeError(
                f"clock must expose now(site), got {type(clock)!r}")
        self.clock = clock
        if self.obs.flight is not None:
            self.clock = self.obs.flight.attach_engine(self)
        self.controller = None
        if ecfg.slo is not None:
            self.controller = AdaptiveController(
                len(self._rung_policies), ecfg.slo, initial_rung=self._rung)
        mixers = {m for m, _ in cfg.layer_kinds()}
        chunkable = M.chunkable(cfg)
        if ecfg.spec is not None:
            self._check_spec(ecfg, mixers, chunkable)
        self.pool_len = ecfg.pool_len
        self.pool = SlotKVPool(cfg, ecfg.max_slots, self.pool_len,
                               self.device)
        self.scheduler = Scheduler(ecfg.scheduler)
        self._preemptible = (ecfg.scheduler is not None
                             and ecfg.scheduler.preemption)
        if self._preemptible and not self.pool.can_cache_prefix:
            raise ValueError(
                "preemption needs full-length self-attention caches: "
                "suspend/resume snapshots slice the time axis by "
                "absolute position (same precondition as the prefix "
                "cache and rollback)")
        self.stats = EngineStats()
        self.states: Dict[int, RequestState] = {}
        self._next_id = 0
        self._closed = False
        if ecfg.prefill_strategy == "auto":
            self.prefill_strategy = "chunked" if chunkable else "whole"
        else:
            if ecfg.prefill_strategy == "chunked" and not chunkable:
                raise ValueError(
                    f"chunked prefill needs plain-attention mixers, got "
                    f"{mixers}")
            self.prefill_strategy = ecfg.prefill_strategy
        self.prefix_cache: Optional[PrefixCache] = None
        if ecfg.prefix_cache:
            self._check_prefix_cache()
            self.prefix_cache = PrefixCache(
                self.pool, ecfg.prefill_chunk, ecfg.prefix_cache_tokens,
                stats_fn=lambda: self.stats, obs_fn=lambda: self.obs)
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
        # compile records; the steps hold the engine weakly (no
        # reference cycle through its graphs)
        me = weakref.ref(self)
        self._decode.on_build = lambda rung: me()._record_compile(
            "decode", rung)
        self._chunk.on_build = lambda key: me()._record_compile(
            "chunk", key[0])
        self.spec_decoder: Optional[SpecDecoder] = None
        if ecfg.spec is not None:
            self.spec_decoder = SpecDecoder(self, ecfg.spec)
            self.spec_decoder.verify_steps.on_build = \
                lambda _gamma: me()._record_compile(
                    "verify", ecfg.spec.verifier_rung)
        if self.controller is not None or self.spec_decoder is not None \
                or self.prefix_cache is not None or self._preemptible \
                or self.obs.quality is not None:
            self.warmup()

    def _check_spec(self, ecfg: EngineConfig, mixers: set,
                    chunkable: bool) -> None:
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
        if not chunkable:
            raise ValueError(
                "speculative decoding needs plain-attention mixers "
                f"(got {mixers}): the verify forward reuses the "
                "chunked write-in-place path and rollback needs "
                "full-length caches")
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

    def _check_prefix_cache(self) -> None:
        """The reference's preconditions of the prefix cache.  Bit-exact
        reuse needs every rung's *effective* prefill policy to be
        independent of the prompt length and prefix-deterministic, or a
        cached prefix would differ from what a cold prefill of the
        reusing request computes.  A multi-rung engine must prefill
        *dense*: rung sp trees differ, so even the per-token ``mask``
        backend would make cached KV rung-dependent."""
        if self.prefill_strategy != "chunked":
            raise ValueError(
                "prefix_cache needs the chunked prefill strategy "
                f"(this arch resolved to {self.prefill_strategy!r}): "
                "rolling-window/SSM caches cannot resume mid-prompt")
        effective = [self._effective_prefill_policy(r)
                     for r in range(len(self._rung_phases))]
        if len(effective) > 1:
            if not all(p.is_dense for p in effective):
                raise ValueError(
                    "prefix_cache on a ladder engine needs every "
                    "rung to prefill dense (a prefix cached at one "
                    "rung seeds requests served at any rung, and "
                    "rung sp trees differ); build the ladder with "
                    "dense_phases=('prefill_dense', 'prefill_sparse')")
        elif not effective[0].prefix_deterministic():
            raise ValueError(
                f"prefix_cache needs a prefix-deterministic prefill "
                f"policy (per-token backends 'off'/'mask'), got "
                f"{effective[0].backend!r}: shared top-k saliency "
                "depends on the call's token rows, so cached KV "
                "would bake in the donor request's chunking and "
                "break the token-parity guarantee")

    def _effective_prefill_policy(self, rung: int) -> SparsityPolicy:
        """The one policy every prefill chunk of ``rung`` runs under —
        well-defined only when the §5.1 phase split cannot produce
        prompt-length-dependent KV (the prefix-cache precondition)."""
        pd, ps, _ = self._rung_phases[rung]
        f = self.ecfg.prefill_dense_frac
        if f >= 1.0:
            return pd
        if f <= 0.0:
            return ps
        if pd != ps:
            raise ValueError(
                f"prefix_cache with prefill_dense_frac={f} needs rung "
                f"{rung}'s prefill_dense and prefill_sparse phase "
                "policies to be equal: the dense/sparse boundary scales "
                "with the prompt length, so a cached prefix would carry "
                "a different phase split than a cold prefill of the "
                "reusing request (set prefill_dense_frac to 0 or 1, or "
                "make both phases dense)")
        return pd

    def _scratch_shapes(self) -> List[tuple]:
        """(B, n, m, blk, elem_bytes, experts) of every ``pallas`` matmul
        the engine can launch before or after a capture: each
        sparsifiable weight at B = max_slots (decode) and, for chunked
        prefill, at B = prefill_chunk (a chunk's token rows).  A MoE
        layer's (reps, E, n, m) expert weights launch once for all E
        experts, at the rows each expert sees (``moe.expert_rows``) in
        decode, a chunk and each speculative verify window.  Where a
        whole-prompt prefill runs ``pallas``, its rows (prompts x length,
        any count up to max_slots x max_len) add :func:`_whole_rows`, so
        the scratch reserved before the first capture is all any launch
        needs."""
        blocks = {pol.block for pol in self._rung_policies
                  if "pallas" in graphs.backends(pol)}
        if not blocks or self.device.type != "cuda":
            return []
        cfg, ecfg = self.cfg, self.ecfg
        whole = self.prefill_strategy == "whole" and any(
            "pallas" in graphs.backends(
                ps if ecfg.prefill_dense_frac <= 0.0 else pd)
            for pd, ps, _ in self._rung_phases)
        S = ecfg.max_slots
        # x of each captured step: (groups, tokens per group)
        steps = [(S, 1)]
        if self.prefill_strategy == "chunked":
            steps.append((1, ecfg.prefill_chunk))
        if ecfg.spec is not None:
            steps += [(S, g + 1) for g in range(ecfg.spec.max_gamma + 1)]
        rows = {S} | ({ecfg.prefill_chunk}
                      if self.prefill_strategy == "chunked" else set())
        expert_rows = {moe.expert_rows(cfg, b, t) for b, t in steps} \
            if cfg.num_experts else set()
        top = ecfg.max_slots * ecfg.max_len
        return graphs.matmul_shapes(
            self.params, blocks, rows, expert_rows,
            (lambda n, m, blk, elem, E: _whole_rows(n, m, blk, elem, E, top))
            if whole else None)

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
        (the ``*_retraces_after_warmup`` stay 0), and neither do prefix
        hits, publishes, suspends or resumes: a segment copy is a
        ``copy_``, with nothing to build (the reference precompiles one
        extract/write executable per quantized length here)."""
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
        if self.obs.quality is not None:
            # builds the shadow-probe and recon steps and fills the
            # roofline counters before the build baseline below, so those
            # builds count as warmup and live probing builds nothing
            self.obs.quality.attach(self)
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
    def probe_retraces_after_warmup(self) -> Optional[int]:
        """Quality probe and recon builds since :meth:`warmup`; None
        without an armed :class:`repro_torch.obs.quality.QualityMonitor`.
        Stays 0 under live probing: both steps are built at warmup with
        the shapes the hot path uses."""
        q = self.obs.quality
        if q is None or not q.armed:
            return None
        return q.retraces_after_warmup

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
        (:func:`repro_torch.serving.graphs.launches`).  Eager passes (a
        whole-prompt prefill, a step's warm call) are in ``counts``
        once each already."""
        steps = [s for s in self._step_kinds() if s is not None]
        if self.obs.quality is not None:
            steps.extend(self.obs.quality.steps())
        return graphs.launches(counts, *steps)

    # ------------------------------------------------------------------
    # telemetry plumbing
    # ------------------------------------------------------------------
    def _record_compile(self, phase: str, rung: int) -> None:
        """Called as a step's build starts (``serving/graphs.py``), so
        every emission is one build: a capture on the card, where the
        reference records one trace.  A build after warmup breaks the
        built-once discipline, and is flagged so the event log shows
        which step broke it."""
        ev = self.obs.events
        if ev is not None:
            ev.emit("compile", phase=phase, rung=rung,
                    after_warmup=self._warm_builds is not None)

    def metrics_exposition(self) -> str:
        """This engine's live stats in Prometheus text-exposition format
        (built per call, off the hot path, from Python counters only —
        see :func:`repro_torch.obs.metrics.engine_registry`)."""
        return obs.engine_exposition(self)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None,
               arrival_time: Optional[float] = None, on_token=None, *,
               priority: Priority = Priority.STANDARD,
               tenant: str = "default",
               queue_deadline_s: Optional[float] = None,
               on_finish=None) -> RequestState:
        """Queue one request.  ``priority`` is a :class:`Priority` or its
        name (``"best-effort"``); a queue at ``SchedulerConfig.max_queue``
        raises :class:`QueueFull` with a retry estimate.  ``on_token``
        (``(request_id, token)``) runs per emitted token and
        ``on_finish`` (``(state)``) once at the end, expiry included."""
        if self._closed:
            raise RuntimeError("submit() on a closed engine")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or prompt.size >= self.ecfg.max_len:
            raise ValueError(
                f"prompt length {prompt.size} outside (0, {self.ecfg.max_len})")
        priority = (Priority.parse(priority) if isinstance(priority, str)
                    else Priority(priority))
        if queue_deadline_s is not None and queue_deadline_s <= 0:
            raise ValueError(
                f"queue_deadline_s must be positive, got {queue_deadline_s}")
        fr = self.obs.flight
        if fr is not None:
            # submit intent first, then its clock read(s), then the
            # decision: the replay loop re-issues the call verbatim
            # when it meets this record at the shared cursor
            fr.record_submit(prompt, max_new_tokens, eos_id, arrival_time,
                             priority, tenant, queue_deadline_s)
        if not self.scheduler.can_accept():
            self.stats.rejected += 1
            retry = self._retry_after()
            if self.obs.events is not None:
                self.obs.events.emit(
                    "reject", reason="queue_full",
                    queue_depth=self.scheduler.queue_depth,
                    retry_after_s=round(retry, 3))
            if fr is not None:
                fr.decision("reject", reason="queue_full",
                            queue_depth=self.scheduler.queue_depth,
                            retry_after_s=round(retry, 3))
            raise QueueFull(
                f"admission queue at capacity "
                f"({self.scheduler.cfg.max_queue})", retry_after=retry)
        max_new = min(max_new_tokens, self.ecfg.max_len - prompt.size)
        req = Request(self._next_id, prompt, max_new,
                      eos_id if eos_id is not None else self.ecfg.eos_id,
                      self._now("submit.arrival") if arrival_time is None
                      else arrival_time,
                      priority=priority, tenant=tenant,
                      queue_deadline_s=queue_deadline_s)
        self._next_id += 1
        rs = RequestState(req, on_token=on_token, on_finish=on_finish)
        self.states[req.request_id] = rs
        self.scheduler.enqueue(rs)
        self.stats.submitted += 1
        tr = self.obs.tracer
        if tr is not None:
            tr.thread_name(req.request_id + 1, f"req {req.request_id}")
            tr.instant("submit", tid=req.request_id + 1,
                       request=req.request_id, prompt_len=req.prompt_len,
                       max_new_tokens=max_new, priority=priority.name.lower(),
                       tenant=tenant)
        return rs

    def _retry_after(self) -> float:
        """Polite-client retry hint: roughly how long until the queued
        work drains — queued requests x observed mean tokens per request
        x mean inter-token gap, floored at 1 s (and 1 s before any
        traffic has calibrated the means)."""
        s = self.stats
        tokens_per_req = s.decode_tokens / s.finished if s.finished else 0.0
        gap = s.tpot_s.mean if s.tpot_s.count else 0.0
        return max(1.0, self.scheduler.queue_depth * tokens_per_req * gap)

    @torch.no_grad()
    def step(self) -> str:
        """Admit (expiring, resuming and preempting as the scheduler
        config allows), then run one scheduler-chosen phase step."""
        self._admit()
        self.stats.sample(self.scheduler.queue_depth, self.pool.num_occupied)
        if self.obs.tracer is not None:
            self.obs.tracer.counter(
                "engine_load", queue_depth=self.scheduler.queue_depth,
                occupancy=self.pool.num_occupied)
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

    # ------------------------------------------------------------------
    # admission, preemption, resume
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """One admission pass: expire deadline-missed queued requests,
        then fill free slots — resuming suspended requests and admitting
        queued ones in priority order, suspending a strictly less
        important decoding victim when preemption is armed and the pool
        is full.  Runs before every phase step, so always at a committed
        KV boundary."""
        sched = self.scheduler
        now = self._now("admit.sweep")
        for rs in sched.expire(now):
            self._expire(rs, now)
        while True:
            rs_s = sched.peek_resume()
            head_p = sched.head_priority()
            if rs_s is None and head_p is None:
                return
            # a suspended request outranks a queued one of the same
            # class: it arrived earlier and already holds partial work
            take_suspended = rs_s is not None and (
                head_p is None or rs_s.request.priority <= head_p)
            target_p = rs_s.request.priority if take_suspended else head_p
            if self.pool.num_free == 0:
                victim = (sched.pick_victim(target_p)
                          if self._preemptible else None)
                if victim is None:
                    return
                self._preempt(victim)
            if take_suspended:
                self._resume(sched.pop_resume())
            else:
                self._admit_queued(sched.pop_admit(), now)

    def _expire(self, rs: RequestState, now: float) -> None:
        req = rs.request
        rs.finish_reason = FinishReason.EXPIRED
        rs.finish_time = now
        rs.status = Status.FINISHED
        self.stats.expired += 1
        waited = now - req.arrival_time
        if self.obs.events is not None:
            self.obs.events.emit(
                "reject", reason="deadline", request=req.request_id,
                waited_s=round(waited, 4),
                deadline_s=req.queue_deadline_s)
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "expire", tid=req.request_id + 1, waited_s=waited)
        fr = self.obs.flight
        if fr is not None:
            fr.decision("reject", reason="deadline", request=req.request_id,
                        waited_s=round(waited, 4),
                        deadline_s=req.queue_deadline_s)
            fr.finish(req.request_id, rs.finish_reason.value,
                      rs.tokens, rs.token_rungs)
        rs.finished()

    def _admit_queued(self, rs: RequestState, now: float) -> None:
        rs.slot = self.pool.alloc()
        if self.prefix_cache is not None:
            self.prefix_cache.admit(rs)     # hit: the cursor jumps past
        rs.status = Status.PREFILL          # the cached prefix
        self.scheduler.prefilling.append(rs)
        self.stats.observe_queue_wait(max(0.0, now - rs.request.arrival_time))
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "admit", tid=rs.request.request_id + 1, slot=rs.slot,
                cached_prefix=rs.next_offset,
                priority=rs.request.priority.name.lower())

    def _preempt(self, victim: RequestState) -> None:
        """Suspend a decoding victim: copy its KV state to host memory at
        a chunk-quantized length and free the slot.  Admission boundary
        only: the slot's KV length equals the victim's committed
        position, which is what makes the later resume bit-identical."""
        t = self._now("preempt")
        req = victim.request
        slot = victim.slot
        seg = self.pool.suspend(slot, self.ecfg.prefill_chunk)
        if seg.length != victim.position:
            raise RuntimeError(
                f"preempt: slot {slot} KV length {seg.length} != request "
                f"{req.request_id} position {victim.position}; suspension "
                "must happen at a committed boundary")
        self.scheduler.suspend(victim)      # pops decoding via the slot
        self.pool.free(slot)                # the host copy has completed
        victim.suspended = seg
        victim.suspend_time = t
        victim.preemptions += 1
        victim.slot = -1
        self.stats.preemptions += 1
        if self.obs.events is not None:
            self.obs.events.emit(
                "preempt", t=t, request=req.request_id, slot=slot,
                kv_length=seg.length, kv_phys=seg.phys,
                priority=req.priority.name.lower(),
                tokens_done=len(victim.tokens))
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "preempt", t=t, tid=req.request_id + 1, slot=slot,
                kv_length=seg.length)
        fr = self.obs.flight
        if fr is not None:
            fr.decision("preempt", request=req.request_id, slot=slot,
                        kv_length=seg.length,
                        tokens_done=len(victim.tokens))

    def _resume(self, rs: RequestState) -> None:
        """Restore a suspended request into a freshly allocated slot:
        write its host-side segment back in place and rejoin the decoding
        set at the exact committed position — generation continues
        bit-identically."""
        t = self._now("resume")
        req = rs.request
        slot = self.pool.alloc()
        self.pool.resume(rs.suspended, slot)
        kv_length = rs.suspended.length
        rs.suspended = None
        rs.slot = slot
        rs.status = Status.DECODE
        self.scheduler.decoding[slot] = rs
        self.stats.resumes += 1
        suspended_s = None
        if rs.suspend_time is not None:
            suspended_s = t - rs.suspend_time
            self.stats.observe_preempted(suspended_s)
            rs.suspend_time = None
        if self.obs.events is not None:
            self.obs.events.emit(
                "resume", t=t, request=req.request_id, slot=slot,
                kv_length=kv_length,
                suspended_s=None if suspended_s is None
                else round(suspended_s, 4))
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "resume", t=t, tid=req.request_id + 1, slot=slot,
                kv_length=kv_length)
        fr = self.obs.flight
        if fr is not None:
            fr.decision("resume", request=req.request_id, slot=slot,
                        kv_length=kv_length)

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
        t0 = self._now("prefill_chunk.t0")
        with self.obs.annotate("repro/prefill_chunk"):
            logits = self._chunk(i, chunk, off, rs.slot, weights)
            sync(self.device)
        t1 = self._now("prefill_chunk.t1")
        dt = t1 - t0
        self.stats.prefill_time += dt
        self.stats.observe_prefill_step(dt)
        self.stats.prefill_chunks += 1
        self.stats.prefill_sparse_chunks += int(not policy.is_dense)
        self.stats.prefill_tokens += real
        if self.obs.tracer is not None:
            self.obs.tracer.complete(
                "prefill_chunk", t0, t1, tid=req.request_id + 1,
                slot=rs.slot, offset=off, tokens=real, rung=self._rung)
        rs.next_offset = off + real
        self.pool.lengths[rs.slot] = rs.next_offset
        if rs.done_prefill:
            if self.prefix_cache is not None:
                # release the admission pin and cache this prompt's
                # prefix before decode can extend the slot
                self.prefix_cache.publish(rs)
            first = int(torch.argmax(logits[0, real - 1]))
            self._start_decode(rs, first)

    def _prefill_whole(self, group: List[RequestState]) -> None:
        P = group[0].request.prompt_len
        tokens = np.stack([rs.request.prompt for rs in group]).astype(np.int64)
        # whole-prompt prefill can't split tokens by phase: any dense
        # fraction > 0 makes the whole prompt dense
        pd, ps, _ = self._rung_phases[self._rung]
        policy = ps if self.ecfg.prefill_dense_frac <= 0.0 else pd
        t0 = self._now("prefill_whole.t0")
        with self.obs.annotate("repro/prefill_whole"):
            logits, caches = self._pstep(
                self.params, torch.from_numpy(tokens).to(self.device),
                self.sp, policy=policy)
            sync(self.device)
        t1 = self._now("prefill_whole.t1")
        dt = t1 - t0
        self.stats.prefill_time += dt
        self.stats.observe_prefill_step(dt)
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += P * len(group)
        if self.obs.tracer is not None:
            self.obs.tracer.complete(
                "prefill_whole", t0, t1, prompt_len=P, batch=len(group),
                rung=self._rung)
        first = torch.argmax(logits, -1).cpu().numpy()
        for b, rs in enumerate(group):
            self.pool.insert(caches, b, rs.slot, P)
            rs.next_offset = P
            self._start_decode(rs, int(first[b]))

    def _start_decode(self, rs: RequestState, first_token: int) -> None:
        rs.first_token_time = self._now("first_token")
        rs.last_token_time = rs.first_token_time
        self.stats.observe_ttft(
            rs.first_token_time - rs.request.arrival_time)
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "first_token", t=rs.first_token_time,
                tid=rs.request.request_id + 1, slot=rs.slot,
                ttft_s=rs.first_token_time - rs.request.arrival_time)
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
        # shadow dense quality probe (sampled): runs *before* the real
        # decode so its K/V writes land exactly on the positions the
        # serving step below overwrites before reading them; served
        # tokens and cache are bit-identical to a probe-free run, and the
        # probe stays outside the timed decode region
        q = self.obs.quality
        probe = None
        if q is not None and q.should_probe():
            probe = q.run_probe(self, tokens, positions, active)
        t0 = self._now("decode.t0")
        with self.obs.annotate("repro/decode"):
            nxt, logits = self._decode(self._rung, tokens, positions, active)
        t1 = self._now("decode.t1")
        self.stats.decode_time += t1 - t0
        self.stats.observe_decode_step(t1 - t0)
        self.stats.decode_steps += 1
        if self.obs.tracer is not None:
            self.obs.tracer.complete(
                "decode_step", t0, t1, active=len(decoding),
                rung=self._rung)
        gaps = []
        for slot, rs in list(decoding.items()):
            tok = int(nxt[slot])
            if rs.last_token_time is not None:
                gaps.append(t1 - rs.last_token_time)
                self.stats.observe_tpot(gaps[-1])
            rs.last_token_time = t1
            self._emit(rs, tok)
            self.pool.commit(slot, 1)
            self._maybe_finish(rs, tok)
        if q is not None and probe is not None:
            q.observe(self, probe, logits, nxt, active, t1)
        if self.controller is not None:
            be_frac = None
            if self.controller.slo.priority_aware:
                be_frac = (sum(
                    1 for rs in decoding.values()
                    if rs.request.priority == Priority.BEST_EFFORT
                ) / len(decoding)) if decoding else 0.0
            qp = None
            if self.controller.slo.quality_aware and q is not None \
                    and q.armed:
                qp = q.pressure
            new_rung = self.controller.update(
                gaps, queue_depth=self.scheduler.queue_depth,
                occupancy=self.pool.num_occupied,
                best_effort_frac=be_frac, quality_pressure=qp)
            if new_rung != self._rung:
                old = self._rung
                self.set_rung(new_rung)
                tr = self.controller.transitions[-1] \
                    if self.controller.transitions else None
                reason = tr[3] if tr is not None else None
                if self.obs.events is not None:
                    self.obs.events.emit(
                        "rung_switch", t=t1, from_rung=old,
                        to_rung=new_rung, reason=reason,
                        controller_step=self.controller.step,
                        queue_depth=self.scheduler.queue_depth)
                if self.obs.tracer is not None:
                    self.obs.tracer.instant(
                        "rung_switch", t=t1, from_rung=old,
                        to_rung=new_rung, reason=reason)
                fr = self.obs.flight
                if fr is not None:
                    fr.decision("rung_switch", from_rung=old,
                                to_rung=new_rung, reason=reason,
                                controller_step=self.controller.step,
                                queue_depth=self.scheduler.queue_depth)

    def _maybe_finish(self, rs: RequestState, token: int) -> None:
        req = rs.request
        if req.eos_id is not None and token == req.eos_id:
            rs.finish_reason = FinishReason.EOS
        elif len(rs.tokens) >= req.max_new_tokens:
            rs.finish_reason = FinishReason.MAX_TOKENS
        else:
            return
        rs.finish_time = self._now("finish")
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "finish", t=rs.finish_time,
                tid=req.request_id + 1, slot=rs.slot,
                reason=rs.finish_reason.value,
                tokens=len(rs.tokens))
        fr = self.obs.flight
        if fr is not None:
            fr.finish(req.request_id, rs.finish_reason.value,
                      rs.tokens, rs.token_rungs)
        self.scheduler.finish(rs)
        self.pool.free(rs.slot)
        self.stats.finished += 1
        rs.finished()

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """One metrics record (JSONL-friendly): engine load, latency
        signals and — under a controller — rung state, in the
        reference's schema (``schema_version``
        :data:`SNAPSHOT_SCHEMA_VERSION`)."""
        s = self.stats
        out = {
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            # a raw out-of-band read, not self._now(): observability
            # reads never consume records of a ReplayClock stream
            "t": obs.now(),
            "queue_depth": self.scheduler.queue_depth,
            "occupancy": self.pool.num_occupied,
            "submitted": s.submitted,
            "finished": s.finished,
            "decode_steps": s.decode_steps,
            "decode_tokens": s.decode_tokens,
            "decode_tps": round(s.decode_tps, 1),
            # whole-run histogram quantiles (bucket upper bounds);
            # *_window_s keeps the recent-window estimate
            "tpot_p50_s": None if not s.tpot_hist
            else round(s.tpot_hist.quantile(50), 6),
            "tpot_p95_s": None if not s.tpot_hist
            else round(s.tpot_hist.quantile(95), 6),
            "tpot_p95_window_s": None if not s.tpot_s
            else round(s.window_tpot_p95(), 6),
        }
        if self.ladder is not None:
            out["rung"] = self._rung
            out["budget"] = self.ladder.budgets[self._rung]
        if self.controller is not None:
            out.update(self.controller.snapshot())
        if self.spec_decoder is not None:
            out.update(self.spec_decoder.snapshot())
            out["spec_accept_rate"] = round(
                s.spec_accepted_tokens / max(1, s.spec_draft_tokens), 4)
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.snapshot())
        if self.ecfg.scheduler is not None:
            out["suspended"] = len(self.scheduler.suspended)
            out["preemptions"] = s.preemptions
            out["resumes"] = s.resumes
            out["rejected"] = s.rejected
            out["expired"] = s.expired
            out["queue_wait_p95_s"] = None if not s.queue_wait_hist \
                else round(s.queue_wait_hist.quantile(95), 6)
        if self.obs.enabled:
            if self.obs.events is not None:
                out["telemetry_events"] = self.obs.events.count
            if self.obs.tracer is not None:
                out["telemetry_spans"] = len(self.obs.tracer.events)
        if self.obs.quality is not None and self.obs.quality.armed:
            out.update(self.obs.quality.snapshot())
        if self.obs.flight is not None:
            fr = self.obs.flight
            out["flight_records"] = fr.count
            out["flight_dropped"] = fr.dropped
            out["flight_dumps"] = len(fr.dumps)
        return out

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def reset_ids(self) -> None:
        """Restart this engine's request-id namespace at 0 and drop
        finished request states, so replays of one trace on a warm
        engine keep ids aligned across engines and reps.  Only valid on
        an idle engine (no queued, in-flight or suspended requests)."""
        if self.scheduler.has_work() or self.pool.num_occupied:
            raise RuntimeError(
                "reset_ids() on a busy engine would orphan live requests")
        self._next_id = 0
        self.states = {}

    def close(self) -> None:
        """Flush and close the engine's telemetry sinks (event log,
        trace export, profiler session) so artifacts are never
        truncated.  Idempotent; further ``submit`` calls raise, but
        existing state stays readable.  Prefer the context-manager form
        (``with Engine(...) as eng:``) so sinks close even when the
        driving loop raises."""
        if self._closed:
            return
        self._closed = True
        self.obs.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and self.obs.flight is not None:
            # black-box trigger: the driving loop died; dump the ring
            # before the sinks close so the incident is capturable
            self.obs.flight.dump("exception")
        self.close()
        return False

    def _now(self, site: str = "") -> float:
        """One engine clock read, tagged with its consuming call site:
        the flight recorder logs the tag next to each observation, so a
        replay divergence names the exact site that desynchronized."""
        return self.clock.now(site)


def _whole_rows(n: int, m: int, blk: int, elem: int, experts: int,
                top: int) -> set:
    """Row counts up to ``top`` at which the split-K scratch of an (n, m)
    matmul (``experts`` of them batched) is largest for its row tile: 8,
    16 and each multiple of 32 (``kernels/sparse_matmul.launch_plan``
    tiles rows by 8, 16 and 32; at any kept-block count the workspace
    and counters grow with the rows of a tile count), where the plan
    splits at all.  Past ``132 / tiles_m`` row tiles it never does."""
    tiles_m = -(-m // K.TILE_COLS[elem])
    cands = [8, 16] + list(range(32, 32 * (K.TARGET_BLOCKS_SHARED // tiles_m
                                           + 2), 32))
    return {b for b in cands if b <= top and K.launch_plan(
        b, n, m, n // blk, blk, False, elem, experts).splits > 1}


