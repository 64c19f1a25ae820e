"""Sparsity quality observability (port of the JAX package's
``obs/quality.py``): how much accuracy is the active rung costing on
live traffic, right now?

The serving stack's other telemetry observes latency and throughput;
the :class:`AdaptiveController` is blind to quality.  WiSparse's own
quality machinery (Eq. 6 block reconstruction error, weight-aware
channel saliency ``|x|·g^alpha``, Eq. 4/5) runs once at calibration time.
The :class:`QualityMonitor` evaluates it on live traffic with four
probes, all riding the engine's built-once discipline:

1. **Shadow dense probes** — a configurable fraction of decode steps is
   re-run through a dense window-1 verify (a
   :class:`~repro_torch.serving.graphs.VerifySteps` at gamma 0, a CUDA
   graph on the card) *before* the real decode.  The probe writes dense
   K/V only at each slot's current position (inactive slots at the
   pool's scratch position), and the decode step that follows attends
   the cache strictly below that position and then writes it: served
   tokens and cache state are bit-exactly those of a probe-free run.
   Per-rung token-agreement and top-k logit-overlap histograms come out
   the other end.
2. **Online block reconstruction error** — the Eq. 6 metric evaluated on
   a window of recently served tokens
   (:class:`~repro_torch.serving.graphs.ReconSteps`): one dense unstacked
   forward collects every block's input and output, each block re-runs
   under the active rung's sp tree with the paper's per-token ``mask``
   numerics, and the per-block MSE is exported as histograms and
   compared against the calibration baselines a v4 ladder artifact
   carries.
3. **Saliency drift detection** — per (block, rung) EWMA Jaccard overlap
   between the live top-k saliency channel set and the calibration-time
   set (the first live observation seeds the reference when the
   artifact has none).  Crossing below the threshold emits a
   ``saliency_drift`` event with (block, rung) attribution and raises
   the ``pressure`` gauge that ``SLOConfig.quality_aware`` reads as a
   de-escalation hint.
4. **Per-rung roofline counters** — at ``warmup()`` every rung's decode
   and chunk step (and the spec verify) gets its FLOPs and bytes from
   :func:`repro_torch.launch.roofline.step_costs` (a count from the
   config and the policy: PyTorch has no XLA cost analysis, so the
   values are the port's own), exported as gauges plus a decode
   utilization against the card's peak rates
   (:mod:`repro_torch.launch.constants`).

Off by default: ``NULL_TELEMETRY.quality is None`` and the engine's only
hot-path touch is one ``is not None`` check.  Built once when on: the
probe and recon steps are built by :meth:`QualityMonitor.attach` (called
from ``Engine.warmup()``) before the engine's build baseline, and
``retraces_after_warmup`` counts their builds after it.  Spec engines
never run the plain decode step, so they expose roofline counters but do
not probe.

The calibration side uses the helpers below too
(:func:`repro_torch.sparsity.ladder.calibrate_ladder`), so live scores
and stored baselines are computed by the same rule."""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.obs.metrics import Histogram, log_buckets

# dedicated Chrome-trace track for quality probes (requests own tids
# request_id+1; this sits far above any realistic request count)
QUALITY_TID = 999_983

# [0, 1] fractions (agreement, top-k overlap) at 1/16 resolution: exact
# means via _sum/_count, bounded exposition cardinality
FRACTION_BUCKETS = tuple(i / 16 for i in range(17))

# Eq. 6 block MSEs span many decades; one bucket per decade
RECON_BUCKETS = log_buckets(1e-9, 1e3, per_decade=1)


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Quality-probe tuning.

    probe_rate       fraction of decode steps shadow-probed, in (0, 1]
                     (deterministic stride — no RNG on the hot path).
    topk             k for the probe's logit-overlap metric.
    drift_threshold  EWMA Jaccard overlap below which a block is
                     drifting, in (0, 1).
    drift_alpha      EWMA smoothing for the per-(block, rung) overlap.
    recon_every      run the reconstruction/saliency pass on every Nth
                     probe (it costs a full window forward; 0 disables).
    recon_window     token window for the reconstruction pass; sampled
                     from the live request with the longest history
                     (skipped until one has at least this many tokens).
    saliency_topk    channel-set size for the live-vs-calibration
                     Jaccard overlap.
    """

    probe_rate: float = 0.05
    topk: int = 8
    drift_threshold: float = 0.5
    drift_alpha: float = 0.2
    recon_every: int = 4
    recon_window: int = 16
    saliency_topk: int = 32

    def __post_init__(self):
        if not 0.0 < self.probe_rate <= 1.0:
            raise ValueError(
                f"probe_rate must be in (0, 1], got {self.probe_rate}")
        if not 0.0 < self.drift_threshold < 1.0:
            raise ValueError(
                f"drift_threshold must be in (0, 1), "
                f"got {self.drift_threshold}")
        if not 0.0 < self.drift_alpha <= 1.0:
            raise ValueError(
                f"drift_alpha must be in (0, 1], got {self.drift_alpha}")
        if self.topk < 1:
            raise ValueError(f"topk must be >= 1, got {self.topk}")
        if self.recon_every < 0:
            raise ValueError(
                f"recon_every must be >= 0, got {self.recon_every}")
        if self.recon_window < 1:
            raise ValueError(
                f"recon_window must be >= 1, got {self.recon_window}")
        if self.saliency_topk < 1:
            raise ValueError(
                f"saliency_topk must be >= 1, got {self.saliency_topk}")


# ---------------------------------------------------------------------------
# shared helpers (the calibration side of the ladder uses these too)
# ---------------------------------------------------------------------------


def rep_saliency_leaf(sp_d, d_model: int):
    """First sparsifiable leaf of a per-depth sp dict whose ``g`` norms
    live on the block-input channel axis -> (g, alpha) as numpy, or
    ``None`` when the block has no such leaf.  Deterministic (sorted
    walk), so calibration and serving always pick the same leaf."""
    def walk(node):
        if not isinstance(node, dict):
            return None
        if "g" in node and "alpha" in node:
            g = np.asarray(torch.as_tensor(node["g"]).detach().cpu(),
                           np.float32)
            if g.ndim == 1 and g.shape[0] == d_model:
                return g, float(torch.as_tensor(node["alpha"]))
            return None
        for k in sorted(node):
            found = walk(node[k])
            if found is not None:
                return found
        return None
    return walk(sp_d)


def saliency_channels(x_mean_abs: np.ndarray, g: np.ndarray, alpha: float,
                      k: int) -> np.ndarray:
    """Top-k channel indices of the WiSparse saliency score
    ``|x| * max(g, 1e-12)^alpha`` (sorted, for stable set compares)."""
    scores = np.asarray(x_mean_abs, np.float32) \
        * np.maximum(np.asarray(g, np.float32), 1e-12) ** float(alpha)
    k = min(int(k), scores.shape[0])
    return np.sort(np.argpartition(-scores, k - 1)[:k]).astype(np.int64)


def unstack_sp(cfg, sp):
    """Stacked group sp tree -> per-depth sp list (inverse of
    :func:`repro_torch.core.unstacked.restack_sp`); the leaves are views
    of the stacked tensors."""
    def index(node, r):
        if isinstance(node, dict):
            return {k: index(v, r) for k, v in node.items()}
        return node[r]

    per_depth = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        gsp = sp[gi]
        for r in range(reps):
            for j in range(len(pattern)):
                per_depth.append(index(gsp[f"l{j}"], r))
    return per_depth


def _jaccard(a: np.ndarray, b: np.ndarray) -> float:
    union = np.union1d(a, b)
    if union.size == 0:
        return 1.0
    return float(np.intersect1d(a, b).size) / float(union.size)


# ---------------------------------------------------------------------------

class QualityMonitor:
    """Live sparsity-quality probes for one engine.

    Construct with a :class:`QualityConfig` (or kwargs) and hand it to
    the engine via ``Telemetry(quality=...)``; ``Engine.warmup()`` calls
    :meth:`attach`, which builds the probe and recon steps and fills the
    roofline counters.  Until then the monitor is inert (``armed`` is
    False and ``should_probe`` always says no)."""

    def __init__(self, cfg: Optional[QualityConfig] = None, **kw):
        if cfg is None:
            cfg = QualityConfig(**kw)
        elif kw:
            raise TypeError("pass a QualityConfig or kwargs, not both")
        self.cfg = cfg
        self.armed = False
        self._stride = max(1, int(round(1.0 / cfg.probe_rate)))
        self._step_idx = 0
        # probe counters/aggregates
        self.probes = 0
        self.probe_tokens = 0
        self.recon_passes = 0
        self.drift_events = 0
        self.pressure = 0.0
        self.agreement_hists: Tuple[Histogram, ...] = ()
        self.overlap_hists: Tuple[Histogram, ...] = ()
        self.recon_hists: Tuple[Histogram, ...] = ()
        # per-(rung, block) saliency state
        self.saliency_ref: Dict[Tuple[int, int], np.ndarray] = {}
        self.saliency_ewma: Dict[Tuple[int, int], float] = {}
        self._drifting: Dict[Tuple[int, int], bool] = {}
        # calibration-time baselines (from a v4 ladder artifact)
        self.recon_baseline: Optional[np.ndarray] = None   # (rungs, blocks)
        self.recon_last: Optional[np.ndarray] = None       # (blocks,)
        self.recon_ratio: Optional[float] = None
        # roofline counters: (phase, rung) -> {"flops", "bytes"}
        self.roofline: Dict[Tuple[str, int], Dict[str, float]] = {}
        self.rates = None               # the card's peak rates, at attach
        self._dtype = "bfloat16"
        # steps (built at attach)
        self.probe_steps = None         # VerifySteps at gamma 0
        self.recon_steps = None         # ReconSteps
        self._ref_sp = None
        self._ref_policy = None
        self._g_alpha = None            # [rung][depth] -> (g, alpha) | None
        self._warm: Optional[Tuple[int, int]] = None
        self._named_track = False
        self._probe_span: Optional[Tuple[float, float]] = None

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def attach(self, engine) -> None:
        """Build the probe and recon steps against ``engine`` and fill
        the per-rung roofline counters.  Called from ``Engine.warmup()``
        on an idle engine (the builds write only the pool's scratch
        position, like the rest of warmup)."""
        from repro_torch.launch import constants
        from repro_torch.launch.roofline import step_costs
        from repro_torch.models import api
        from repro_torch.serving.graphs import ReconSteps, VerifySteps
        from repro_torch.sparsity import SparsityPolicy

        R = engine.num_rungs
        # the build hooks hold the engine weakly (no reference cycle
        # through its graphs, as the engine's own hooks)
        me = weakref.ref(engine)
        if len(self.agreement_hists) != R:
            self.agreement_hists = tuple(
                Histogram(FRACTION_BUCKETS) for _ in range(R))
            self.overlap_hists = tuple(
                Histogram(FRACTION_BUCKETS) for _ in range(R))
            self.recon_hists = tuple(
                Histogram(RECON_BUCKETS) for _ in range(R))
        dev = engine.device
        self.rates = constants.peak_rates(
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else None)
        self._dtype = engine.cfg.dtype

        # -- dense reference for shadow probes --------------------------
        # ladder engines probe against rung 0 (the quality reference the
        # ladder was calibrated to); if rung 0 itself is not dense, or
        # the engine runs a fixed policy, a plain dense policy over the
        # same sp tree is the reference.
        self._ref_sp = engine._rung_sp[0]
        ref_pol = engine._rung_phases[0][2]
        if not ref_pol.is_dense:
            ref_pol = SparsityPolicy.dense().for_phase("decode")
        self._ref_policy = ref_pol
        if self.probe_steps is None:
            self.probe_steps = VerifySteps(
                api.make_verify_step(engine.cfg), engine.params,
                engine.pool.caches, ref_pol, self._ref_sp, [0],
                engine.ecfg.max_slots, engine.pool_len, engine.graph_space)
            self.probe_steps.on_build = \
                lambda _g: me()._record_compile("quality_probe", 0)
        self.probe_steps.build(0)

        # -- reconstruction / saliency step ------------------------------
        # one step covers every rung: ladder rungs share one sp schema
        if self.cfg.recon_every > 0 and all(
                sp is not None for sp in engine._rung_sp):
            if self.recon_steps is None:
                self.recon_steps = ReconSteps(
                    engine.cfg, engine.params, engine._rung_sp[0],
                    self.cfg.recon_window, engine.graph_space)
                self.recon_steps.on_build = \
                    lambda _k: me()._record_compile("quality_recon", 0)
            self.recon_steps.build(0)
            # host-side (g, alpha) of each block's representative leaf,
            # per rung: the live saliency scoring inputs
            self._g_alpha = [
                [rep_saliency_leaf(sp_d, engine.cfg.d_model)
                 for sp_d in unstack_sp(engine.cfg, sp)]
                for sp in engine._rung_sp]

        # -- calibration baselines from the ladder artifact (v4) --------
        ladder = getattr(engine, "ladder", None)
        qb = getattr(ladder, "baselines", None) if ladder is not None \
            else None
        if qb is not None:
            recon = qb.get("recon")
            if recon is not None:
                self.recon_baseline = np.asarray(recon, np.float64)
            channels = qb.get("channels")
            if channels is not None:
                for r, per_block in enumerate(channels):
                    for d, ch in enumerate(per_block):
                        ch = np.asarray(ch, np.int64)
                        if ch.size:
                            self.saliency_ref[(r, d)] = ch

        # -- per-rung roofline counters (a count, nothing runs) ----------
        cfg, ecfg = engine.cfg, engine.ecfg
        for r, ((pd, _ps, dec), sp) in enumerate(
                zip(engine._rung_phases, engine._rung_sp)):
            flops, byts = step_costs(cfg, ecfg, dec, sp, "decode")
            self.roofline[("decode", r)] = {"flops": flops, "bytes": byts}
            if engine.prefill_strategy == "chunked":
                flops, byts = step_costs(cfg, ecfg, pd, sp, "chunk")
                self.roofline[("chunk", r)] = {"flops": flops,
                                               "bytes": byts}
        if engine.spec_decoder is not None:
            sd = engine.spec_decoder
            _, _, ver_pol = engine._rung_phases[sd.verifier_rung]
            ver_sp = engine._rung_sp[sd.verifier_rung]
            for g in ecfg.spec.gammas():
                flops, byts = step_costs(cfg, ecfg, ver_pol, ver_sp,
                                         "verify", gamma=g)
                self.roofline[(f"verify{g}", sd.verifier_rung)] = {
                    "flops": flops, "bytes": byts}

        self._warm = self._builds()
        self.armed = True

    def _builds(self) -> Tuple[int, int]:
        return (self.probe_steps.builds,
                0 if self.recon_steps is None else self.recon_steps.builds)

    def steps(self) -> tuple:
        """The monitor's built steps (for the engine's launch count)."""
        return tuple(s for s in (self.probe_steps, self.recon_steps)
                     if s is not None)

    @property
    def retraces_after_warmup(self) -> Optional[int]:
        """Probe + recon builds since :meth:`attach`; the quality
        invariant is that this stays 0 under live probing."""
        if self._warm is None:
            return None
        now = self._builds()
        return (now[0] - self._warm[0]) + (now[1] - self._warm[1])

    # ------------------------------------------------------------------
    # hot path (Engine._decode_step)
    # ------------------------------------------------------------------
    def should_probe(self) -> bool:
        """Deterministic stride sampling over decode steps."""
        if not self.armed:
            return False
        hit = self._step_idx % self._stride == 0
        self._step_idx += 1
        return hit

    def run_probe(self, engine, tokens, positions, active):
        """Shadow dense probe for one decode step, run *before* the real
        decode: a window-1 dense verify whose K/V writes land exactly on
        the positions the following decode step overwrites before it
        reads them.  Returns the probe's f32 logits (slots, vocab) on the
        device (on the card the graph's static output: :meth:`observe`
        copies it to the host before the next probe).  Waits for the
        probe, so its span is its own time, not the decode's."""
        from repro_torch.device import sync
        dev = engine.device
        t0 = clock.now()
        _, logits = self.probe_steps(
            0, torch.from_numpy(tokens).reshape(-1, 1).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(active).reshape(-1, 1).to(dev))
        sync(dev)
        self._probe_span = (t0, clock.now())
        return logits[:, 0]

    def observe(self, engine, probe, logits, nxt: np.ndarray,
                active: np.ndarray, t: float) -> None:
        """Score one probed step (after the real decode, on the host):
        per-rung agreement and top-k overlap, plus, every
        ``recon_every`` probes, the reconstruction/saliency pass.
        ``probe`` and ``logits`` are the probe's and the decode step's
        logits, copied to the host here before either step runs again."""
        slots = np.nonzero(np.asarray(active) > 0)[0]
        if slots.size == 0:
            return
        rung = engine.rung
        self.probes += 1
        self.probe_tokens += int(slots.size)
        both = torch.stack([probe.float(), logits.float()]).cpu().numpy()
        probe, serving = both[0], both[1]
        k = min(self.cfg.topk, probe.shape[-1])
        agree = 0
        overlap = 0.0
        for s in slots:
            if int(np.argmax(probe[s])) == int(nxt[s]):
                agree += 1
            pa = np.argpartition(-probe[s], k - 1)[:k]
            sa = np.argpartition(-serving[s], k - 1)[:k]
            overlap += np.intersect1d(pa, sa).size / k
        agreement = agree / slots.size
        overlap /= slots.size
        self.agreement_hists[rung].observe(agreement)
        self.overlap_hists[rung].observe(overlap)
        tr = engine.obs.tracer
        if tr is not None:
            if not self._named_track:
                tr.thread_name(QUALITY_TID, "quality")
                self._named_track = True
            span = self._probe_span or (t, t)
            tr.complete("quality_probe", span[0], span[1],
                        tid=QUALITY_TID, rung=rung,
                        agreement=round(agreement, 4),
                        topk_overlap=round(overlap, 4),
                        slots=int(slots.size))
        if self.recon_steps is not None and self.cfg.recon_every > 0 \
                and self.probes % self.cfg.recon_every == 0:
            self._recon_pass(engine, rung, t)

    # ------------------------------------------------------------------
    # reconstruction + saliency drift
    # ------------------------------------------------------------------
    def _live_window(self, engine) -> Optional[np.ndarray]:
        """The last ``recon_window`` tokens of the live request with the
        longest prompt+generated history (a fixed shape: the recon step
        is built once); None until one is long enough."""
        W = self.cfg.recon_window
        best = None
        for rs in engine.scheduler.decoding.values():
            n = rs.request.prompt_len + len(rs.tokens)
            if n >= W and (best is None or n > best[0]):
                best = (n, rs)
        if best is None:
            return None
        rs = best[1]
        seq = np.concatenate([np.asarray(rs.request.prompt, np.int64),
                              np.asarray(rs.tokens, np.int64)])
        return seq[-W:].reshape(1, W)

    def _recon_pass(self, engine, rung: int, t: float) -> None:
        window = self._live_window(engine)
        if window is None:
            return
        errs, feats = self.recon_steps(window, engine._rung_sp[rung])
        errs = errs.cpu().numpy().astype(np.float64)
        feats = feats.cpu().numpy().astype(np.float32)
        self.recon_passes += 1
        self.recon_last = errs
        for e in errs:
            self.recon_hists[rung].observe(float(e))
        if self.recon_baseline is not None \
                and rung < self.recon_baseline.shape[0]:
            base = float(np.mean(self.recon_baseline[rung]))
            self.recon_ratio = float(np.mean(errs)) / max(base, 1e-12)
        self._saliency_pass(engine, rung, feats, t)

    def _saliency_pass(self, engine, rung: int, feats: np.ndarray,
                       t: float) -> None:
        cfg = self.cfg
        ga = self._g_alpha[rung] if self._g_alpha is not None else None
        if ga is None:
            return
        for d in range(feats.shape[0]):
            if d >= len(ga) or ga[d] is None:
                continue
            g, alpha = ga[d]
            live = saliency_channels(feats[d], g, alpha, cfg.saliency_topk)
            key = (rung, d)
            ref = self.saliency_ref.get(key)
            if ref is None:
                # no calibration baseline (pre-v4 artifact / uniform
                # ladder): the first live observation is the reference
                self.saliency_ref[key] = live
                self.saliency_ewma[key] = 1.0
                continue
            jac = _jaccard(live, ref)
            a = cfg.drift_alpha
            prev = self.saliency_ewma.get(key)
            ewma = jac if prev is None else (1 - a) * prev + a * jac
            self.saliency_ewma[key] = ewma
            below = ewma < cfg.drift_threshold
            if below and not self._drifting.get(key, False):
                self.drift_events += 1
                ev = engine.obs.events
                if ev is not None:
                    ev.emit("saliency_drift", t=t, block=d, rung=rung,
                            overlap=round(ewma, 4),
                            threshold=cfg.drift_threshold)
                tr = engine.obs.tracer
                if tr is not None:
                    tr.instant("saliency_drift", t=t, tid=QUALITY_TID,
                               block=d, rung=rung,
                               overlap=round(ewma, 4))
                fr = engine.obs.flight
                if fr is not None:
                    # a drift edge is a black-box trigger (see
                    # FlightRecorder.decision)
                    fr.decision("saliency_drift", block=d, rung=rung,
                                overlap=round(ewma, 4),
                                threshold=cfg.drift_threshold)
            self._drifting[key] = below
        self._update_pressure(rung)

    def _update_pressure(self, rung: int) -> None:
        """Quality pressure in [0, 1]: how far below the drift threshold
        the active rung's worst block EWMA sits (0 = no drift)."""
        thr = self.cfg.drift_threshold
        worst = 0.0
        for (r, _d), ewma in self.saliency_ewma.items():
            if r == rung:
                worst = max(worst, (thr - ewma) / thr)
        self.pressure = float(np.clip(worst, 0.0, 1.0))

    def seed_reference(self, rung: int, block: int,
                       channels: np.ndarray) -> None:
        """Install a saliency reference channel set for (rung, block), as
        loading a v4 ladder does; for tests and for operators
        re-baselining a drifted deployment."""
        self.saliency_ref[(rung, block)] = \
            np.sort(np.asarray(channels, np.int64))
        self.saliency_ewma.pop((rung, block), None)
        self._drifting.pop((rung, block), None)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def recon_baseline_mean(self, rung: int) -> Optional[float]:
        if self.recon_baseline is None \
                or rung >= self.recon_baseline.shape[0]:
            return None
        return float(np.mean(self.recon_baseline[rung]))

    def decode_utilization(self, measured_step_s: float) -> Dict[int, float]:
        """Per-rung achieved-vs-roofline decode utilization: the step's
        least time on the card (the larger of its bytes over the memory
        rate and its FLOPs over the peak rate for the model's dtype) over
        the measured mean decode step.  One measured mean covers all
        rungs, as in the reference."""
        out: Dict[int, float] = {}
        if measured_step_s <= 0 or self.rates is None:
            return out
        for (phase, r), cost in self.roofline.items():
            if phase != "decode":
                continue
            ideal = max(cost["flops"] / self.rates.flops(self._dtype),
                        cost["bytes"] / self.rates.hbm_bw)
            out[r] = ideal / measured_step_s
        return out

    def snapshot(self) -> dict:
        def hist_mean(hists):
            count = sum(h.count for h in hists)
            if not count:
                return None
            return round(sum(h.sum for h in hists) / count, 6)
        out = {
            "quality_probes": self.probes,
            "quality_probe_tokens": self.probe_tokens,
            "quality_agreement_mean": hist_mean(self.agreement_hists),
            "quality_topk_overlap_mean": hist_mean(self.overlap_hists),
            "quality_recon_mean": hist_mean(self.recon_hists),
            "quality_drift_events": self.drift_events,
            "quality_pressure": round(self.pressure, 4),
        }
        if self.recon_ratio is not None:
            out["quality_recon_vs_baseline"] = round(self.recon_ratio, 4)
        return out
