"""SLO-aware adaptive sparsity controller (port of the JAX package's
``serving/controller.py``; plain Python over plain numbers, copied).

The engine serves a :class:`repro_torch.sparsity.PolicyLadder` — rung 0
is the densest (highest quality) policy, the last rung the sparsest
(fastest).  The controller closes the loop: after every decode step it
reads the engine's load signals (per-request inter-token gaps = TPOT,
queue depth; slot occupancy rides along as telemetry) against an
:class:`SLOConfig` and decides which rung the *next* step should run.
On the card a rung switch only selects another captured decode graph:
every rung's decode step is built once, at warmup
(``repro_torch.serving.graphs``).

Stability machinery, because a bang-bang controller on a noisy latency
signal will oscillate:

* **EWMA smoothing** of the TPOT signal (reset on each switch so the old
  rung's latencies don't bleed into the new rung's estimate);
* **hysteresis** — escalate when the EWMA exceeds the target, but only
  de-escalate when it is *comfortably* below (``target * (1 -
  hysteresis)``) and the queue has drained;
* **dwell time** — a minimum number of decode steps between switches, so
  each rung's EWMA converges before it is judged;
* **per-rung TPOT memory** — de-escalation to a rung whose last measured
  EWMA violated the target is refused until that estimate expires
  (``estimate_ttl`` steps), which prevents the classic down-up limit
  cycle when the lower rung fundamentally cannot meet the SLO.

``priority_aware`` and ``quality_aware`` are kept as the reference has
them; the port's engine refuses both until the priority scheduler and
the quality monitor are ported.  The speculative-decoding sibling,
:class:`SpecController`, tunes the draft length (and optionally the
drafter rung) from the acceptance rate; on the card a switch only
selects another captured verify or decode graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Service-level objectives + controller tuning.

    tpot_p95      target p95 inter-token latency, seconds.  The EWMA of
                  observed gaps is compared against it (an EWMA tracks
                  the bulk of the distribution; the benchmark reports
                  the true p95 against this same number).
    max_queue     queued (unadmitted) requests beyond which the
                  controller escalates regardless of latency.
    ewma_alpha    smoothing factor for the TPOT EWMA.
    hysteresis    de-escalation headroom: step down only when the EWMA
                  is below ``tpot_p95 * (1 - hysteresis)``.
    dwell         minimum decode steps between rung switches.
    estimate_ttl  decode steps a per-rung TPOT estimate stays trusted
                  when deciding whether a lower rung would hold the SLO.
    priority_aware  when True, TPOT-driven escalation targets best-effort
                  traffic first: a latency violation only escalates when
                  the decoding batch actually contains best-effort
                  requests (batched decode runs one policy per step, so
                  rung is the whole batch's quality knob — with an
                  all-interactive batch the controller holds the rung and
                  lets priority admission + preemption shed load
                  instead).  Queue-pressure escalation is unaffected.
    quality_aware  when True, the controller also reads the
                  ``QualityMonitor`` (the observability slice) drift
                  pressure as an *advisory* de-escalation hint: positive
                  pressure (the active rung's live saliency has drifted
                  from its calibration plan) relaxes to the rung below
                  when the queue is empty, the TPOT EWMA still fits the
                  target, dwell has elapsed, and the lower rung's last
                  estimate would hold — i.e. quality can only spend
                  latency headroom, never cause an SLO violation.
    """

    tpot_p95: float
    max_queue: int = 8
    ewma_alpha: float = 0.25
    hysteresis: float = 0.25
    dwell: int = 12
    estimate_ttl: int = 500
    priority_aware: bool = False
    quality_aware: bool = False

    def __post_init__(self):
        if self.tpot_p95 <= 0:
            raise ValueError(f"tpot_p95 must be > 0, got {self.tpot_p95}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in [0, 1), got {self.hysteresis}")
        if self.dwell < 1:
            raise ValueError(f"dwell must be >= 1, got {self.dwell}")


class AdaptiveController:
    """Feedback controller mapping load signals to a ladder rung index.

    Drive it with :meth:`update` once per decode step.  It is plain
    python over plain numbers — the engine feeds it real measurements,
    tests feed it synthetic traces."""

    def __init__(self, num_rungs: int, slo: SLOConfig,
                 initial_rung: int = 0):
        if num_rungs < 1:
            raise ValueError("controller needs at least one rung")
        if not 0 <= initial_rung < num_rungs:
            raise ValueError(
                f"initial_rung {initial_rung} outside [0, {num_rungs})")
        self.num_rungs = num_rungs
        self.slo = slo
        self.rung = initial_rung
        self.step = 0
        self._since_switch = slo.dwell        # free to act immediately
        self._ewma: Optional[float] = None
        # last converged EWMA seen at each rung + the step it was recorded
        self._rung_est: List[Optional[Tuple[float, int]]] = \
            [None] * num_rungs
        self.residency = [0] * num_rungs      # decode steps spent per rung
        self.transitions: List[Tuple[int, int, int, str]] = \
            []                                # (step, from, to, reason)
        self.last_occupancy = 0               # telemetry (see update())
        self.held_escalations = 0             # priority_aware: TPOT
        #                                       violations not acted on
        #                                       because the batch had no
        #                                       best-effort traffic
        self.quality_deescalations = 0        # quality_aware: steps down
        #                                       taken on drift pressure

    # ------------------------------------------------------------------
    @property
    def tpot_ewma(self) -> Optional[float]:
        return self._ewma

    def _observe(self, gaps: Sequence[float]) -> None:
        a = self.slo.ewma_alpha
        for g in gaps:
            self._ewma = g if self._ewma is None else \
                (1 - a) * self._ewma + a * g
        if self._ewma is not None:
            self._rung_est[self.rung] = (self._ewma, self.step)

    def _switch(self, to: int, reason: str) -> None:
        self.transitions.append((self.step, self.rung, to, reason))
        self.rung = to
        self._since_switch = 0
        self._ewma = None          # old rung's latencies don't carry over

    def _lower_rung_would_hold(self) -> bool:
        """Trust a fresh estimate of the rung below; with no (or a stale)
        estimate, probing down is allowed — the queue is empty, so a
        brief violation is cheap and refreshes the estimate."""
        est = self._rung_est[self.rung - 1]
        if est is None:
            return True
        value, at = est
        if self.step - at > self.slo.estimate_ttl:
            return True
        return value <= self.slo.tpot_p95 * (1.0 - self.slo.hysteresis)

    # ------------------------------------------------------------------
    def update(self, gaps: Sequence[float], queue_depth: int,
               occupancy: int = 0,
               best_effort_frac: Optional[float] = None,
               quality_pressure: Optional[float] = None) -> int:
        """One control tick (call after each decode step).

        gaps: the step's observed inter-token gaps, seconds (one per
        active request that emitted a non-first token).  Returns the rung
        the next step should run.

        occupancy is recorded for telemetry (:meth:`snapshot`) but does
        not actuate: admission fills free slots before the queue can
        grow, so whenever ``queue_depth`` exceeds the threshold the pool
        is already saturated — queue depth subsumes occupancy as the
        admission-pressure signal.

        best_effort_frac: fraction of the decoding batch in the
        best-effort class (only consulted when ``slo.priority_aware``):
        a TPOT violation with no best-effort traffic holds the rung
        (counted in ``held_escalations``) so quality degradation lands
        on best-effort requests before interactive ones.

        quality_pressure: the QualityMonitor's saliency-drift pressure
        in [0, 1] (only consulted when ``slo.quality_aware``): positive
        pressure de-escalates one rung when there is latency headroom —
        escalation always wins, so quality hints can never push the
        engine into an SLO violation."""
        self.last_occupancy = occupancy
        self.step += 1
        self.residency[self.rung] += 1
        self._since_switch += 1
        self._observe(gaps)
        if self._since_switch < self.slo.dwell:
            return self.rung

        slo = self.slo
        ewma = self._ewma
        over_tpot = ewma is not None and ewma > slo.tpot_p95
        over_queue = queue_depth > slo.max_queue
        if (slo.priority_aware and over_tpot and not over_queue
                and best_effort_frac is not None and best_effort_frac <= 0
                and self.rung < self.num_rungs - 1):
            self.held_escalations += 1
            return self.rung
        if (over_tpot or over_queue) and self.rung < self.num_rungs - 1:
            self._switch(self.rung + 1,
                         "tpot" if over_tpot else "queue")
        elif (slo.quality_aware and quality_pressure is not None
              and quality_pressure > 0.0
              and self.rung > 0 and queue_depth == 0
              and (ewma is None or ewma <= slo.tpot_p95)
              and self._lower_rung_would_hold()):
            # advisory quality de-escalation: the active rung's live
            # saliency drifted off its calibration plan and there is
            # latency headroom, so spend it on a denser rung.  Gated
            # more loosely than "idle" (no hysteresis margin): drift is
            # a quality signal, not a latency optimization.
            self.quality_deescalations += 1
            self._switch(self.rung - 1, "quality")
        elif (self.rung > 0 and queue_depth == 0
              and ewma is not None
              and ewma < slo.tpot_p95 * (1.0 - slo.hysteresis)
              and self._lower_rung_would_hold()):
            self._switch(self.rung - 1, "idle")
        return self.rung

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Controller state for metrics/JSONL export.

        ``tpot_estimator`` names the signal the controller actually
        steers on — its own reset-on-switch EWMA, deliberately neither
        the whole-run histogram quantile nor the windowed ring p95 that
        ``EngineStats.summary()`` reports (see
        ``repro_torch.serving.metrics``)."""
        total = max(1, sum(self.residency))
        snap = {
            "rung": self.rung,
            "tpot_estimator": "ewma",
            "tpot_ewma_s": None if self._ewma is None
            else round(self._ewma, 6),
            "occupancy": self.last_occupancy,
            "switches": len(self.transitions),
            "rung_residency": [round(r / total, 4) for r in self.residency],
        }
        if self.slo.priority_aware:
            snap["held_escalations"] = self.held_escalations
        if self.slo.quality_aware:
            snap["quality_deescalations"] = self.quality_deescalations
        return snap


class SpecController:
    """Adaptive speculative-decoding controller: tunes the draft length
    gamma — and optionally the drafter rung — from the measured acceptance
    EWMA, since acceptance is workload-dependent.

    Same stability machinery as :class:`AdaptiveController`: the per-round
    accepted-draft fraction feeds an EWMA (reset on every switch so the
    old operating point doesn't bleed into the new one's estimate), and a
    dwell of ``dwell`` verify rounds rate-limits switches.  When the EWMA
    is high (``raise_at``) the drafts are cheap and trustworthy, so gamma
    grows toward ``gamma_max``; once gamma is maxed a drafter-adaptive
    controller instead moves the drafter to a *sparser* rung (cheaper
    drafts).  When the EWMA is low (``lower_at``) the verifier is throwing
    drafts away, so gamma shrinks toward ``gamma_min``; at the floor a
    drafter-adaptive controller falls back to a *denser* drafter rung
    (more faithful drafts).  Every operating point the controller can
    reach is precompiled by ``Engine.warmup()``, so switches are
    retrace-free."""

    def __init__(self, gamma: int, gamma_min: int, gamma_max: int, *,
                 drafter_rung: int, drafter_min: int, drafter_max: int,
                 adapt_drafter: bool = False, alpha: float = 0.2,
                 raise_at: float = 0.8, lower_at: float = 0.4,
                 dwell: int = 8):
        if not 1 <= gamma_min <= gamma <= gamma_max:
            raise ValueError(
                f"need 1 <= gamma_min <= gamma <= gamma_max, got "
                f"({gamma_min}, {gamma}, {gamma_max})")
        if not drafter_min <= drafter_rung <= drafter_max:
            raise ValueError(
                f"drafter rung {drafter_rung} outside "
                f"[{drafter_min}, {drafter_max}]")
        if not 0.0 <= lower_at < raise_at <= 1.0:
            raise ValueError(
                f"need 0 <= lower_at < raise_at <= 1, got "
                f"({lower_at}, {raise_at})")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if dwell < 1:
            raise ValueError(f"dwell must be >= 1, got {dwell}")
        self.gamma = gamma
        self.gamma_min, self.gamma_max = gamma_min, gamma_max
        self.drafter_rung = drafter_rung
        self.drafter_min, self.drafter_max = drafter_min, drafter_max
        self.adapt_drafter = adapt_drafter
        self.alpha = alpha
        self.raise_at, self.lower_at = raise_at, lower_at
        self.dwell = dwell
        self.step = 0
        self._since_switch = dwell           # free to act immediately
        self._ewma: Optional[float] = None
        self.transitions: List[Tuple[int, int, int, str]] = \
            []                               # (step, gamma, drafter, reason)

    @property
    def accept_ewma(self) -> Optional[float]:
        return self._ewma

    def _switch(self, gamma: int, drafter: int, reason: str) -> None:
        self.gamma, self.drafter_rung = gamma, drafter
        self.transitions.append((self.step, gamma, drafter, reason))
        self._since_switch = 0
        self._ewma = None        # the old operating point's acceptance
        #                          doesn't predict the new one's

    def update(self, accept_frac: float) -> Tuple[int, int]:
        """One tick per spec round with the round's mean accepted-draft
        fraction over active slots; returns the (gamma, drafter_rung) the
        next round should run."""
        self.step += 1
        self._since_switch += 1
        a = self.alpha
        self._ewma = accept_frac if self._ewma is None else \
            (1 - a) * self._ewma + a * accept_frac
        if self._since_switch < self.dwell:
            return self.gamma, self.drafter_rung
        if self._ewma >= self.raise_at:
            if self.gamma < self.gamma_max:
                self._switch(self.gamma + 1, self.drafter_rung, "accept")
            elif self.adapt_drafter and self.drafter_rung < self.drafter_max:
                self._switch(self.gamma, self.drafter_rung + 1, "accept")
        elif self._ewma <= self.lower_at:
            if self.gamma > self.gamma_min:
                self._switch(self.gamma - 1, self.drafter_rung, "reject")
            elif self.adapt_drafter and self.drafter_rung > self.drafter_min:
                self._switch(self.gamma, self.drafter_rung - 1, "reject")
        return self.gamma, self.drafter_rung

    def snapshot(self) -> dict:
        return {
            "spec_gamma": self.gamma,
            "spec_drafter_rung": self.drafter_rung,
            "spec_accept_ewma": None if self._ewma is None
            else round(self._ewma, 4),
            "spec_switches": len(self.transitions),
        }
