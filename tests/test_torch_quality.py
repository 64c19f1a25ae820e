"""The port's quality monitor against the JAX package's
(``tests/test_quality.py``), on the reduced llama31_8b (f32) with
JAX-initialised weights carried by ``models/params.from_numpy`` and
JAX's uniform ladder [0.0, 0.5, 0.7] (prefill dense) carried by the
ladder artifact.

- ``QualityConfig`` refuses what JAX's refuses, with its messages, under
  hypothesis; the probe stride is deterministic; with no monitor the
  engine builds no probe step and exposes nothing of it.
- Probes at the dense rung: tokens equal with and without probes and the
  JAX engine's, agreement exactly 1.0, no build after warmup, roofline
  keys equal JAX's.
- Probes at a sparse rung with injected baselines: per-rung agreement
  and overlap histograms (counts and sums) equal JAX's, recon histogram
  counts equal and sums within rtol 1e-4, ``recon_last`` per block within
  rtol 1e-4 of JAX's on the same window, ``recon_vs_baseline`` equal
  within the same tolerance; the ``repro_quality_*`` families of the
  exposition equal JAX's.
- A forced saliency drift gives JAX's drift events (block, rung,
  overlap), and under ``SLOConfig.quality_aware`` the controller's
  ``quality`` de-escalation, transition for transition with the JAX
  engine.
- ``launch/roofline.step_costs``: FLOPs within 1e-9 (relative) of
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the same eager
  step (decode and chunk, dense and ``pallas``, and the verify), bytes
  equal to a hand sum of parameter and cache bytes; the H100 rates.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils.flop_counter import FlopCounterMode

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticLM
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SLOConfig as JSLOConfig
from repro.serving.controller import AdaptiveController as JController
from repro.sparsity import PolicyLadder as JLadder
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.launch import constants
from repro_torch.launch.roofline import step_costs
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.obs import metrics as tmetrics
from repro_torch.serving import Engine, EngineConfig, SLOConfig, SpecConfig
from repro_torch.serving.controller import AdaptiveController
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

KW = dict(max_slots=2, max_len=32, prefill_chunk=8)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    jladder = JLadder.uniform(
        jparams, jcfg, (0.0, 0.5, 0.7),
        dense_phases=("prefill_dense", "prefill_sparse"))
    path = str(tmp_path_factory.mktemp("ladder") / "ladder.npz")
    jladder.save(path)
    return dict(jcfg=jcfg, jparams=jparams, jladder=jladder,
                cfg=reduced(get_config("llama31_8b")),
                params=P.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams)),
                ladder=PolicyLadder.load(path, device="cpu"))


def _prompts(cfg, n, seq, step=0):
    return np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, n)).batch(step))


def _pair(model, rung=0, jladder=None, ladder=None, jtel=None, ttel=None,
          **kw):
    """(JAX engine, port engine) over the same weights and ladder."""
    ekw = dict(KW, initial_rung=rung, **kw)
    slo = ekw.pop("slo", None)
    jeng = JEngine(model["jparams"], model["jcfg"], JEngineConfig(
        slo=None if slo is None else JSLOConfig(**slo), **ekw), None,
        ladder=jladder or model["jladder"], telemetry=jtel)
    teng = Engine(model["params"], model["cfg"], EngineConfig(
        slo=None if slo is None else SLOConfig(**slo), **ekw), None,
        device="cpu", ladder=ladder or model["ladder"], telemetry=ttel)
    return jeng, teng


def _run(eng, prompts, gen=6):
    eng.warmup()
    for p in prompts:
        eng.submit(p, gen)
    return eng.run()


def _hists(q):
    return [[(h.counts, h.count, h.sum) for h in hs]
            for hs in (q.agreement_hists, q.overlap_hists)]


# ---------------------------------------------------------------------------
# config + stride + null path
# ---------------------------------------------------------------------------

_cfg_kw = st.fixed_dictionaries({}, optional={
    "probe_rate": st.floats(-0.5, 1.5, allow_nan=False),
    "drift_threshold": st.floats(-0.5, 1.5, allow_nan=False),
    "drift_alpha": st.floats(-0.5, 1.5, allow_nan=False),
    "topk": st.integers(-2, 4),
    "recon_every": st.integers(-2, 4),
    "recon_window": st.integers(-2, 4),
    "saliency_topk": st.integers(-2, 4)})


@settings(max_examples=200, deadline=None)
@given(kw=_cfg_kw)
def test_quality_config_errors_equal_jax(kw):
    outs = []
    for mod in (obs, jobs):
        try:
            outs.append(dataclasses.asdict(mod.QualityConfig(**kw)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]
    for mod in (obs, jobs):
        with pytest.raises(TypeError, match="not both"):
            mod.QualityMonitor(mod.QualityConfig(), probe_rate=0.5)


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.3, 0.05])
def test_probe_stride_is_deterministic(rate):
    seqs = []
    for mod in (obs, jobs):
        q = mod.QualityMonitor(probe_rate=rate)
        assert not q.should_probe()          # inert until attach() arms it
        q.armed = True
        seqs.append([q.should_probe() for _ in range(41)])
        assert q.retraces_after_warmup is None   # no warm baseline yet
    assert seqs[0] == seqs[1]
    assert seqs[0][:2] == [True, rate == 1.0]


def test_null_path_builds_no_probe(model):
    assert obs.NULL_TELEMETRY.quality is None
    eng = Engine(model["params"], model["cfg"], EngineConfig(**KW),
                 device="cpu")
    assert eng.clock is obs.SYSTEM_CLOCK
    eng.submit(_prompts(model["cfg"], 1, 8)[0], 3)
    eng.run()
    snap = eng.snapshot()
    assert snap["schema_version"] == 7
    assert not any(k.startswith("quality_") for k in snap)
    assert eng.probe_retraces_after_warmup is None
    assert "repro_quality_probes_total" not in eng.metrics_exposition()
    # a monitor that was never attached builds nothing
    q = obs.QualityMonitor(probe_rate=1.0)
    assert q.probe_steps is None and q.recon_steps is None and not q.armed


# ---------------------------------------------------------------------------
# shadow probes against the JAX monitor
# ---------------------------------------------------------------------------

def test_probe_parity_dense_agreement_and_roofline(model):
    """Probing at the dense rung: tokens equal to a probe-free run and to
    the JAX engine's, agreement exactly 1.0, no probe build after warmup,
    roofline counters under JAX's keys."""
    prompts = _prompts(model["cfg"], 2, 8)
    jq = jobs.QualityMonitor(probe_rate=1.0, recon_every=0)
    tq = obs.QualityMonitor(probe_rate=1.0, recon_every=0)
    jeng, teng = _pair(model, jtel=jobs.Telemetry(quality=jq),
                       ttel=obs.Telemetry(quality=tq))
    jout, tout = _run(jeng, prompts), _run(teng, prompts)
    _, bare = _pair(model)
    assert tout == _run(bare, prompts) == jout
    assert tq.probes == jq.probes > 0 and tq.probe_tokens == jq.probe_tokens
    assert teng.probe_retraces_after_warmup == 0
    assert teng.decode_retraces_after_warmup == 0
    assert tq.recon_steps is None            # recon_every=0 builds none
    snap, jsnap = teng.snapshot(), jeng.snapshot()
    assert snap["quality_agreement_mean"] == 1.0 == \
        jsnap["quality_agreement_mean"]
    for k in ("quality_probes", "quality_probe_tokens",
              "quality_topk_overlap_mean", "quality_recon_mean",
              "quality_drift_events", "quality_pressure"):
        assert snap[k] == jsnap[k], k
    assert _hists(tq) == _hists(jq)
    assert set(tq.roofline) == set(jq.roofline)
    assert all(c["flops"] > 0 and c["bytes"] > 0
               for c in tq.roofline.values())
    util = tq.decode_utilization(1e-3)
    assert set(util) == {0, 1, 2} and all(u > 0 for u in util.values())
    assert tq.decode_utilization(0.0) == {}
    # probes launch through the probe step (one per probed decode step)
    assert tq.probe_steps.steps[0] == tq.probes


@pytest.fixture(scope="module")
def sparse_runs(model):
    """One probed run at rung 1 with injected baselines in each package
    (recon on every probe), and a probe-free port run."""
    L = model["cfg"].num_layers
    base = {"recon": np.full((3, L), 1e-8),
            "channels": tuple(tuple(np.arange(4, dtype=np.int64)
                                    for _ in range(L)) for _ in range(3))}
    jl = dataclasses.replace(model["jladder"], baselines=base)
    tl = dataclasses.replace(model["ladder"], baselines=base)
    qkw = dict(probe_rate=1.0, recon_every=1, recon_window=8,
               saliency_topk=4)
    jq, tq = jobs.QualityMonitor(**qkw), obs.QualityMonitor(**qkw)
    jeng, teng = _pair(model, rung=1, jladder=jl, ladder=tl,
                       jtel=jobs.Telemetry(quality=jq),
                       ttel=obs.Telemetry(quality=tq))
    prompts = _prompts(model["cfg"], 2, 8, step=1)
    out = dict(jout=_run(jeng, prompts), tout=_run(teng, prompts),
               jeng=jeng, teng=teng, jq=jq, tq=tq)
    _, bare = _pair(model, rung=1)
    out["bare"] = _run(bare, prompts)
    return out


def test_sparse_rung_histograms_and_recon_equal_jax(sparse_runs):
    r = sparse_runs
    jq, tq = r["jq"], r["tq"]
    assert r["tout"] == r["bare"] == r["jout"]   # probes change no token
    assert tq.probes == jq.probes and tq.recon_passes == jq.recon_passes > 0
    assert _hists(tq) == _hists(jq)
    for th, jh in zip(tq.recon_hists, jq.recon_hists):
        assert th.count == jh.count and th.counts == jh.counts
        assert th.sum == pytest.approx(jh.sum, rel=1e-4, abs=0)
    np.testing.assert_allclose(tq.recon_last, jq.recon_last, rtol=1e-4)
    assert tq.recon_baseline_mean(1) == pytest.approx(1e-8)
    assert tq.recon_ratio == pytest.approx(jq.recon_ratio, rel=1e-4)
    assert r["teng"].probe_retraces_after_warmup == 0
    snap, jsnap = r["teng"].snapshot(), r["jeng"].snapshot()
    assert list(k for k in snap if k.startswith("quality_")) == \
        list(k for k in jsnap if k.startswith("quality_"))
    assert snap["quality_recon_vs_baseline"] == pytest.approx(
        jsnap["quality_recon_vs_baseline"], rel=1e-4)
    assert tq.saliency_ewma.keys() == jq.saliency_ewma.keys()
    assert tq.drift_events == jq.drift_events
    assert tq.pressure == pytest.approx(jq.pressure, abs=1e-12)


def _families(text):
    types, samples = tmetrics.parse_exposition(text)
    return types, {n: v for n, _lb, v in samples}


def test_quality_exposition_equals_jax(sparse_runs):
    """The ``repro_quality_*`` series are JAX's; every value equal but the
    roofline gauges and the decode utilization (the port's own count,
    where JAX reads XLA's) and the recon sums (rtol 1e-4)."""
    ttext = sparse_runs["teng"].metrics_exposition()
    jtext = sparse_runs["jeng"].metrics_exposition()
    assert obs.validate_exposition(ttext) > 0
    ttypes, tvals = _families(ttext)
    jtypes, jvals = _families(jtext)
    tq = {n: v for n, v in tvals.items() if n.startswith("repro_quality_")}
    jq = {n: v for n, v in jvals.items() if n.startswith("repro_quality_")}
    assert set(tq) == set(jq) and len(tq) > 20
    assert {n: t for n, t in ttypes.items()
            if n.startswith("repro_quality_")} == \
        {n: t for n, t in jtypes.items() if n.startswith("repro_quality_")}
    for family in ("repro_quality_probes_total",
                   "repro_quality_probe_agreement_rung1_count",
                   "repro_quality_recon_error_rung1_count",
                   "repro_quality_recon_baseline_rung1",
                   "repro_quality_roofline_flops_decode_rung1",
                   "repro_quality_decode_utilization_rung1",
                   "repro_quality_pressure"):
        assert family in tq, family
    for n, v in tq.items():
        if "roofline" in n or "utilization" in n:
            assert v > 0
        elif n.startswith("repro_quality_recon_error") and \
                n.endswith("_sum"):
            assert v == pytest.approx(jq[n], rel=1e-4)
        else:
            assert v == pytest.approx(jq[n], rel=0, abs=1e-12), n


def test_forced_saliency_drift_equals_jax(model):
    """Re-baselining block 0 to channels live traffic never selects fires
    one attributed saliency_drift event per package, equal (block, rung,
    overlap), and raises the pressure gauge."""
    qkw = dict(probe_rate=1.0, recon_every=1, recon_window=8,
               saliency_topk=8, drift_threshold=0.9, drift_alpha=1.0)
    jtel = jobs.Telemetry(events=jobs.EventLog(capacity=128),
                          quality=jobs.QualityMonitor(**qkw))
    ttel = obs.Telemetry(events=obs.EventLog(capacity=128),
                         quality=obs.QualityMonitor(**qkw))
    jeng, teng = _pair(model, rung=1, jtel=jtel, ttel=ttel)
    cfg = model["cfg"]

    def drift(tel):
        return [(e["block"], e["rung"], e["overlap"], e["threshold"])
                for e in tel.events.events("saliency_drift")]

    for eng in (jeng, teng):
        _run(eng, [_prompts(cfg, 1, 8, step=2)[0]])
    assert drift(ttel) == drift(jtel)
    jq, tq = jtel.quality, ttel.quality
    assert tq.saliency_ref[(1, 0)].tolist() == jq.saliency_ref[(1, 0)].tolist()
    n0, ev0 = tq.drift_events, len(drift(ttel))
    disjoint = np.setdiff1d(np.arange(cfg.d_model), jq.saliency_ref[(1, 0)])[:8]
    for q, eng in ((jq, jeng), (tq, teng)):
        q.seed_reference(1, 0, disjoint)
        eng.submit(_prompts(cfg, 1, 8, step=3)[0], 6)
        eng.run()
    assert drift(ttel) == drift(jtel)
    assert tq.drift_events > n0 and tq.pressure > 0.0
    assert tq.pressure == pytest.approx(jq.pressure, abs=1e-12)
    # (the untrained model's window-to-window jitter may trip the tight
    # threshold on its own; the forced edge is the one after ev0)
    b0 = [e for e in drift(ttel)[ev0:] if e[0] == 0]
    assert len(b0) == 1 and b0[0][1] == 1 and b0[0][2] < 0.9
    assert teng.snapshot()["quality_drift_events"] == tq.drift_events


def test_quality_aware_controller_deescalates_like_jax(model):
    """``SLOConfig.quality_aware`` (refused before this port): a forced
    drift on the sparse rung makes the controller step down with reason
    ``quality``, at the same step as the JAX engine's."""
    qkw = dict(probe_rate=1.0, recon_every=1, recon_window=8,
               saliency_topk=8, drift_threshold=0.9, drift_alpha=1.0)
    slo = dict(tpot_p95=1e6, max_queue=8, dwell=1, quality_aware=True)
    jq, tq = jobs.QualityMonitor(**qkw), obs.QualityMonitor(**qkw)
    jeng, teng = _pair(model, rung=1, slo=slo,
                       jtel=jobs.Telemetry(quality=jq),
                       ttel=obs.Telemetry(quality=tq))
    cfg = model["cfg"]
    disjoint = np.arange(cfg.d_model)[-8:]
    outs = []
    for q, eng in ((jq, jeng), (tq, teng)):
        for d in range(cfg.num_layers):
            q.seed_reference(1, d, disjoint)
        for p in _prompts(cfg, 2, 8, step=4):
            eng.submit(p, 8)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert teng.controller.transitions == jeng.controller.transitions
    assert any(t[3] == "quality" for t in teng.controller.transitions)
    assert teng.controller.quality_deescalations == \
        jeng.controller.quality_deescalations > 0
    assert teng.snapshot()["quality_deescalations"] == \
        jeng.snapshot()["quality_deescalations"]


_updates = st.lists(st.tuples(
    st.lists(st.floats(0.0, 0.2), max_size=3), st.integers(0, 4),
    st.one_of(st.none(), st.floats(0.0, 1.0))), min_size=1, max_size=30)


@settings(max_examples=100, deadline=None)
@given(updates=_updates, aware=st.booleans(), rung=st.integers(0, 2),
       tpot=st.sampled_from([0.001, 0.05, 1.0]))
def test_controller_quality_hint_equals_jax(updates, aware, rung, tpot):
    """The controller's ``quality`` branch under random gaps, queues and
    pressures: the port's transitions equal JAX's (the hint never
    overrides an SLO escalation or a queue)."""
    slo = dict(tpot_p95=tpot, dwell=1, quality_aware=aware)
    t = AdaptiveController(3, SLOConfig(**slo), initial_rung=rung)
    j = JController(3, JSLOConfig(**slo), initial_rung=rung)
    for gaps, queue, pressure in updates:
        assert t.update(gaps, queue_depth=queue,
                        quality_pressure=pressure) == \
            j.update(gaps, queue_depth=queue, quality_pressure=pressure)
    assert t.transitions == j.transitions
    assert t.quality_deescalations == j.quality_deescalations
    assert t.snapshot().get("quality_deescalations") == \
        j.snapshot().get("quality_deescalations")


def test_ladder_baselines_feed_the_monitor_like_jax(model, tmp_path):
    """A v4 ladder artifact written by JAX with baselines: the port's
    monitor reads the same recon baseline and saliency references as the
    JAX monitor."""
    L = model["cfg"].num_layers
    recon = np.arange(3 * L, dtype=float).reshape(3, L) + 1e-6
    channels = tuple(tuple(np.arange(d, d + 4, dtype=np.int64)
                           for d in range(L)) for _ in range(3))
    jl = dataclasses.replace(model["jladder"], baselines={
        "recon": recon, "channels": channels})
    path = str(tmp_path / "v4.npz")
    jl.save(path)
    tl = PolicyLadder.load(path, device="cpu")
    jq, tq = jobs.QualityMonitor(recon_every=1), obs.QualityMonitor(
        recon_every=1)
    _pair(model, jladder=jl, ladder=tl, jtel=jobs.Telemetry(quality=jq),
          ttel=obs.Telemetry(quality=tq))
    np.testing.assert_array_equal(tq.recon_baseline, jq.recon_baseline)
    assert {k: v.tolist() for k, v in tq.saliency_ref.items()} == \
        {k: v.tolist() for k, v in jq.saliency_ref.items()}
    for r in range(3):
        assert tq.recon_baseline_mean(r) == jq.recon_baseline_mean(r)


# ---------------------------------------------------------------------------
# the step-cost count
# ---------------------------------------------------------------------------

def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _hand_bytes(cfg, params, ecfg, phase, weight_frac=1.0):
    """Parameter bytes the step reads (the embedding's gathered rows, the
    projection weights scaled by the kept fraction, norms, LM head) plus
    the K/V cache bytes its attention reads."""
    elem = 4 if cfg.dtype == "float32" else 2
    rows = {"decode": ecfg.max_slots, "chunk": ecfg.prefill_chunk}[phase]
    proj = norms = 0
    for group in params["groups"]:
        for layer in group.values():
            norms += layer["ln1"].nbytes + layer["ln2"].nbytes
            proj += sum(w.nbytes for w in layer["attn"].values())
            proj += sum(w.nbytes for w in layer["mlp"].values())
    T = ecfg.pool_len
    slots = 1 if phase == "chunk" else ecfg.max_slots
    kv = 2 * cfg.num_layers * slots * cfg.num_kv_heads * cfg.head_dim \
        * T * elem
    return (rows * cfg.d_model * elem + proj * weight_frac + norms
            + params["final_norm"].nbytes + params["lm_head"].nbytes + kv)


@pytest.mark.parametrize("backend", ["off", "pallas", "topk_shared"])
@pytest.mark.parametrize("phase", ["decode", "chunk"])
def test_step_costs_equal_the_flop_counter(model, backend, phase):
    cfg, params = model["cfg"], model["params"]
    ecfg = EngineConfig(max_slots=4, max_len=40, prefill_chunk=8)
    dense = backend == "off"
    policy = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    sp = None if dense else default_sp_stacked(params, cfg, keep_frac=0.5,
                                               tau=float("-inf"))
    T = ecfg.pool_len
    caches = api.init_caches(cfg, ecfg.max_slots, T, device="cpu")
    S, C = ecfg.max_slots, ecfg.prefill_chunk
    with torch.no_grad():
        if phase == "decode":
            step = api.make_slot_decode_step(cfg)
            counted = _counted(lambda: step(
                params, torch.zeros(S, dtype=torch.long),
                torch.arange(S), caches, sp, torch.ones(S),
                policy=policy))
        else:
            step = api.make_chunk_prefill_step(cfg)
            counted = _counted(lambda: step(
                params, torch.zeros((1, C), dtype=torch.long),
                torch.zeros(1, dtype=torch.long), torch.tensor(1), caches,
                sp, torch.ones(C), policy=policy))
    flops, nbytes = step_costs(cfg, ecfg, policy, sp, phase)
    assert flops == pytest.approx(counted, rel=1e-9)
    frac = 1.0 if dense else 0.5       # every reduced projection: 0.5 of
    #                                    its 16-wide blocks or rows
    assert nbytes == pytest.approx(
        _hand_bytes(cfg, params, ecfg, phase, frac), rel=1e-12)


def test_verify_costs(model):
    cfg, params = model["cfg"], model["params"]
    spec = SpecConfig(gamma=2, drafter_rung=1, adaptive=True, gamma_max=3)
    ecfg = EngineConfig(max_slots=2, max_len=40, prefill_chunk=8, spec=spec)
    eng = Engine(params, cfg, ecfg, device="cpu", ladder=model["ladder"])
    assert eng.pool_len == 40 + 8 and EngineConfig(**KW).pool_len == 32 + 8
    g = 3
    step = api.make_verify_step(cfg)
    caches = api.init_caches(cfg, 2, eng.pool_len, device="cpu")
    with torch.no_grad():
        counted = _counted(lambda: step(
            params, torch.zeros((2, g + 1), dtype=torch.long),
            torch.zeros(2, dtype=torch.long), caches, None,
            torch.ones((2, g + 1)), policy=SparsityPolicy.dense()))
    flops, _ = step_costs(cfg, ecfg, SparsityPolicy.dense(), None,
                          "verify", gamma=g)
    assert flops == pytest.approx(counted, rel=1e-9)
    with pytest.raises(ValueError, match="gamma"):
        step_costs(cfg, ecfg, SparsityPolicy.dense(), None, "verify")
    with pytest.raises(ValueError, match="phase"):
        step_costs(cfg, ecfg, SparsityPolicy.dense(), None, "train")
    # a spec engine's monitor fills the verify rows under JAX's keys
    q = obs.QualityMonitor(probe_rate=1.0, recon_every=0)
    Engine(params, cfg, ecfg, device="cpu", ladder=model["ladder"],
           telemetry=obs.Telemetry(quality=q))
    assert {k for k in q.roofline if k[0].startswith("verify")} == \
        {(f"verify{g}", 0) for g in spec.gammas()}


def test_h100_rates_and_utilization():
    sxm, pcie = constants.peak_rates("NVIDIA H100 80GB HBM3"), \
        constants.peak_rates("NVIDIA H100 PCIe")
    assert sxm == (3.35e12, 989e12, 67e12) == constants.peak_rates(None)
    assert pcie == (2.0e12, 756e12, 51e12)
    assert sxm.flops("bfloat16") == constants.PEAK_FLOPS_BF16
    assert sxm.flops("float32") == constants.PEAK_FLOPS_F32
    q = obs.QualityMonitor()
    q.rates, q._dtype = sxm, "bfloat16"
    q.roofline = {("decode", 0): {"flops": 989e9, "bytes": 3.35e9},
                  ("decode", 1): {"flops": 0.0, "bytes": 6.7e9},
                  ("chunk", 0): {"flops": 1e15, "bytes": 1.0}}
    util = q.decode_utilization(0.004)
    assert util == {0: pytest.approx(0.25), 1: pytest.approx(0.5)}
    assert math.isclose(q.decode_utilization(0.002)[1], 1.0)
