"""The port's telemetry against the JAX package's, on the reduced
llama31_8b (f32) with JAX-initialised weights carried across by
``models/params.from_numpy``.

- ``Histogram.quantile``, ``log_buckets`` and ``percentile`` equal JAX's
  under hypothesis; ``MetricsRegistry.render`` is byte-equal for the
  same registrations; ``validate_exposition``/``parse_exposition`` agree
  on valid and malformed texts; ``EventLog`` rotation files are
  byte-equal for fixed timestamps; ``validate_chrome_trace`` agrees.
- ``EngineStats.summary()`` equals JAX's, keys and values, for the same
  observations (the port used to take every percentile from its rings,
  unrounded and under other keys).
- Engine telemetry on the same trace as the JAX engine, for a plain
  engine, a ladder under the SLO controller (rung switches), a spec
  engine (KV rollbacks), a prefix cache with evictions, preemption, and
  admission control (queue full, deadline): tokens equal, event
  sequences equal by kind and every field that is not a time (``compile``
  held to "none after warmup" instead: the port records a graph build
  where JAX records a trace), span sequences equal the same way,
  expositions with the same series and equal counts, snapshots with the
  same keys, and full telemetry changes no token.
- The lifecycle: ``close()`` flushes the trace sink, also after an
  exception, and is idempotent; ``reset_ids()``; the profiler window.

Time-valued fields (``t``, ``*_s`` durations, span ``ts``/``dur``) are
the only ones excluded from equality."""
import json
import math

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticLM
from repro.models import api as japi
from repro.obs import metrics as jmetrics
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import QueueFull as JQueueFull
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import SLOConfig as JSLOConfig
from repro.serving import SpecConfig as JSpecConfig
from repro.serving.metrics import EngineStats as JStats
from repro.serving.metrics import percentile as jpercentile
from repro.sparsity import PolicyLadder as JLadder
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.models import params as P
from repro_torch.obs import metrics as tmetrics
from repro_torch.serving import (SNAPSHOT_SCHEMA_VERSION, Engine,
                                 EngineConfig, QueueFull, SchedulerConfig,
                                 SLOConfig, SpecConfig)
from repro_torch.serving.metrics import EngineStats, percentile
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

# event and span fields that are times (excluded from equality)
TIME_FIELDS = {"t", "ts", "dur", "waited_s", "suspended_s", "retry_after_s",
               "ttft_s"}
# snapshot fields that are times or rates, and the event count (the
# port's compile records are builds, JAX's are traces)
SNAPSHOT_SKIP = {"t", "decode_tps", "tpot_p50_s", "tpot_p95_s",
                 "tpot_p95_window_s", "tpot_ewma_s", "queue_wait_p95_s",
                 "telemetry_events"}


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=reduced(get_config("llama31_8b")),
                params=P.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams)))


def _prompts(cfg, n, seq, step=0):
    return np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, n)).batch(step))


def _ladders(model, backend, **kw):
    jl = JLadder.uniform(model["jparams"], model["jcfg"], budgets=(0.0, 0.5),
                         backend=backend, **kw)
    tl = PolicyLadder(
        budgets=jl.budgets,
        policies=tuple(SparsityPolicy.from_dict(p.to_dict())
                       for p in jl.policies),
        sps=tuple(P.from_numpy(jax.tree_util.tree_map(np.asarray, sp))
                  for sp in jl.sps))
    return jl, tl


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

_vals = st.lists(st.floats(0.0, 50.0, allow_nan=False), max_size=60)


@settings(max_examples=150, deadline=None)
@given(vals=_vals, p=st.floats(0.0, 100.0),
       lo_exp=st.integers(-7, -2), decades=st.integers(1, 6),
       per_decade=st.integers(1, 8))
def test_histogram_quantile_and_buckets_equal_jax(vals, p, lo_exp, decades,
                                                  per_decade):
    lo, hi = 10.0 ** lo_exp, 10.0 ** (lo_exp + decades)
    bounds = tmetrics.log_buckets(lo, hi, per_decade)
    assert bounds == jmetrics.log_buckets(lo, hi, per_decade)
    assert tmetrics.DEFAULT_LATENCY_BUCKETS == \
        jmetrics.DEFAULT_LATENCY_BUCKETS
    th, jh = tmetrics.Histogram(bounds), jmetrics.Histogram(bounds)
    for v in vals:
        th.observe(v)
        jh.observe(v)
    assert th.counts == jh.counts and th.count == jh.count
    assert th.sum == jh.sum and th.cumulative() == jh.cumulative()
    a, b = th.quantile(p), jh.quantile(p)
    assert a == b or (math.isnan(a) and math.isnan(b))
    if vals:
        assert percentile(vals, p) == jpercentile(vals, p)


def test_instrument_validation_equals_jax():
    for mod in (tmetrics, jmetrics):
        with pytest.raises(ValueError, match="0 < lo < hi"):
            mod.log_buckets(1.0, 0.5)
        with pytest.raises(ValueError, match="per_decade"):
            mod.log_buckets(per_decade=0)
        with pytest.raises(ValueError, match="strictly increasing"):
            mod.Histogram((1.0, 1.0))
        with pytest.raises(ValueError, match="only go up"):
            mod.Counter().inc(-1)
        reg = mod.MetricsRegistry()
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name")
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")


def _registry(mod, values):
    reg = mod.MetricsRegistry()
    reg.counter("repro_a_total", "a counter").inc(3)
    reg.counter("repro_b_total").inc(2.5)
    reg.gauge("repro_g", "a gauge").set(-1.25)
    h = reg.histogram("repro_h_seconds", "a histogram")
    u = mod.Histogram(tuple(float(i) for i in range(5)))
    reg.register_histogram("repro_u", u, "unit buckets")
    for v in values:
        h.observe(v)
        u.observe(round(v))
    return reg


@settings(max_examples=60, deadline=None)
@given(values=_vals)
def test_registry_render_is_byte_equal_to_jax(values):
    text = _registry(tmetrics, values).render()
    assert text == _registry(jmetrics, values).render()
    assert tmetrics.validate_exposition(text) == \
        jmetrics.validate_exposition(text)
    assert tmetrics.parse_exposition(text) == \
        jmetrics.parse_exposition(text)


_MALFORMED = [
    "",
    "# TYPE x counter\n",
    "x 1\n",
    "# TYPE x counter\nx -1\n",
    "# TYPE x gauge\nx nan\n",
    "# TYPE x counter\nx{a=\"b\"} one two\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n"
    "h_sum 1\nh_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_sum 1\nh_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 1\nh_count 1\n",
    "# TYPE h histogram\nh 3\n",
    "# HELP x y\n# TYPE x counter\nx 1\ny_total 2\n",
]


@pytest.mark.parametrize("text", _MALFORMED)
def test_validate_exposition_rejects_as_jax(text):
    errs = []
    for mod in (tmetrics, jmetrics):
        with pytest.raises(ValueError) as exc:
            mod.validate_exposition(text)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_event_log_rotation_is_byte_equal(tmp_path):
    paths = []
    for name, mod in (("port", obs), ("jax", jobs)):
        path = str(tmp_path / f"{name}.jsonl")
        log = mod.EventLog(capacity=4, sink=path, max_sink_bytes=200)
        for i in range(12):
            log.emit("kv_rollback", t=float(i), slot=i % 2, tokens=i,
                     depths=[i, i + 1])
        assert log.sink_rotations >= 2 and log.count == 12
        assert [e["tokens"] for e in log.events()] == [8, 9, 10, 11]
        assert log.events("nope") == [] and len(log) == 4
        log.close()
        log.close()
        paths.append(path)
    for suffix in ("", ".1"):
        with open(paths[0] + suffix, "rb") as a, \
                open(paths[1] + suffix, "rb") as b:
            assert a.read() == b.read()
    for mod in (obs, jobs):
        with pytest.raises(ValueError, match="path sink"):
            mod.EventLog(max_sink_bytes=10)


def test_span_tracer_equals_jax(tmp_path):
    docs = []
    for mod in (obs, jobs):
        tr = mod.SpanTracer(origin=100.0)
        tr.thread_name(1, "req 0")
        tr.thread_name(1, "ignored")
        tr.complete("prefill_chunk", 100.5, 100.25, tid=1, offset=0)
        tr.instant("first_token", t=101.0, tid=1, slot=0)
        tr.counter("engine_load", t=101.5, queue_depth=2, occupancy=1)
        path = str(tmp_path / f"{mod.__name__}.json")
        tr.export(path)
        with open(path) as f:
            docs.append(json.load(f))
        assert len(tr) == 5
    assert docs[0] == docs[1]
    assert obs.validate_chrome_trace(docs[0]) == 5
    for bad in ({}, {"traceEvents": []}, {"traceEvents": [{"ph": "Q"}]},
                {"traceEvents": [{"ph": "X", "name": "a", "pid": 1,
                                  "tid": 0, "ts": 0, "dur": -1}]},
                {"traceEvents": [{"ph": "i", "name": "a", "pid": 1,
                                  "tid": 0}]}):
        errs = []
        for mod in (obs, jobs):
            with pytest.raises(ValueError) as exc:
                mod.validate_chrome_trace(bad)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# EngineStats.summary(): the fault this port repaired
# ---------------------------------------------------------------------------

_OBSERVE = ("tpot", "ttft", "decode_step", "prefill_step", "spec_draft",
            "spec_verify", "queue_wait", "preempted")
_COUNTERS = ("submitted", "finished", "prefill_chunks", "prefill_tokens",
             "decode_steps", "decode_tokens", "spec_rounds", "spec_verifies",
             "spec_draft_tokens", "spec_accepted_tokens",
             "spec_committed_tokens", "prefix_lookups", "prefix_hits",
             "prefix_tokens_saved", "rejected", "expired", "preemptions",
             "resumes")
_ops = st.lists(st.one_of(
    st.tuples(st.sampled_from(_OBSERVE), st.floats(0.0, 20.0)),
    st.tuples(st.just("spec_accepted"), st.integers(0, 20)),
    st.tuples(st.sampled_from(_COUNTERS), st.integers(1, 5)),
    st.tuples(st.sampled_from(("prefill_time", "decode_time")),
              st.floats(0.0, 3.0)),
    st.tuples(st.just("sample"), st.tuples(st.integers(0, 9),
                                           st.integers(0, 8))),
    st.tuples(st.just("prefix_hit_len"), st.integers(1, 64))),
    max_size=80)


def _apply(stats, ops):
    for op, v in ops:
        if op in _OBSERVE or op == "spec_accepted":
            getattr(stats, f"observe_{op}")(v)
        elif op == "sample":
            stats.sample(*v)
        elif op == "prefix_hit_len":
            stats.prefix_hit_len.append(v)
        else:
            setattr(stats, op, getattr(stats, op) + v)
    return stats


@settings(max_examples=200, deadline=None)
@given(ops=_ops)
def test_engine_stats_summary_equals_jax(ops):
    t, j = _apply(EngineStats(), ops), _apply(JStats(), ops)
    assert t.summary() == j.summary()
    assert list(t.summary()) == list(j.summary())
    assert t.window_tpot_p95() == j.window_tpot_p95() or not t.tpot_s
    assert t.tpot_percentile(95) == j.tpot_percentile(95) or not t.tpot_hist


def test_summary_percentiles_are_bucket_bounds_like_jax():
    """A 14 ms step reads as the 15.85 ms bucket bound in both packages
    (5 buckets per decade); the exact value stays in the port's rings."""
    t, j = EngineStats(), JStats()
    for s in (t, j):
        for _ in range(3):
            s.observe_tpot(0.014)
            s.observe_ttft(0.2)
    assert t.summary() == j.summary()
    assert t.summary()["tpot_p50_s"] == 0.01585
    assert "tpot_p95_window_s" in t.summary()
    assert not {"decode_step_p50_s", "prefill_step_p50_s",
                "prefill_sparse_chunks"} & set(t.summary())
    assert percentile(t.tpot_s, 50) == 0.014
    assert percentile(t.ttft_s, 50) == 0.2


# ---------------------------------------------------------------------------
# engine telemetry against the JAX engine
# ---------------------------------------------------------------------------

def _full(mod):
    return mod.Telemetry(tracer=mod.SpanTracer(), events=mod.EventLog())


def _strip(d):
    return {k: v for k, v in d.items() if k not in TIME_FIELDS}


def _events(tel):
    return [_strip(e) for e in tel.events.events() if e["kind"] != "compile"]


def _spans(tel):
    return [(e["ph"], e["name"], e["tid"], _strip(e.get("args", {})))
            for e in tel.tracer.events]


def _exposition(eng):
    types, samples = tmetrics.parse_exposition(eng.metrics_exposition())
    return types, {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}


def _counts(types, samples):
    """Samples that count something: counters, gauges and histogram
    ``_count``s, minus the ones that are times."""
    out = {}
    for (name, labels), v in samples.items():
        base = name[:-len("_count")] if name.endswith("_count") else name
        kind = types.get(base)
        if kind == "histogram" and name.endswith("_count"):
            out[name] = v
        elif kind in ("counter", "gauge") and "seconds" not in name:
            out[name] = v
    return out


def _run_case(eng, case, prompts):
    """Drive one engine through a case's trace -> {request id: tokens}."""
    if case == "prefix":
        out = {}
        for p in prompts:
            rs = eng.submit(p, 3)
            eng.run()
            out[rs.request.request_id] = rs.tokens
        return out
    if case == "preempt":
        eng.submit(prompts[0], 16, priority="best-effort", tenant="batch")
        eng.submit(prompts[1], 16, priority="best-effort", tenant="batch")
        for _ in range(64):
            eng.step()
            if (len(eng.scheduler.decoding) == 2
                    and all(len(rs.tokens) >= 2
                            for rs in eng.scheduler.decoding.values())):
                break
        eng.submit(prompts[2], 4, priority="interactive", tenant="chat")
        return eng.run()
    if case == "admission":
        # expired on arrival (its deadline lies in the past), then a full
        # queue refuses a third submission
        eng.submit(prompts[0], 4, arrival_time=obs.now() - 10.0,
                   queue_deadline_s=1.0)
        eng.submit(prompts[1], 4)
        with pytest.raises((QueueFull, JQueueFull)):
            eng.submit(prompts[2], 4)
        return eng.run()
    for p in prompts:
        eng.submit(p, 10 if case == "ladder" else 6)
    return eng.run()


def _engines(model, case):
    """(jax engine kwargs, port engine kwargs, prompts) for a case."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    base = dict(max_slots=2, max_len=32, prefill_chunk=8)
    jkw, tkw = {}, {}
    if case == "plain":
        jc, tc = JEngineConfig(**base), EngineConfig(**base)
        prompts = _prompts(cfg, 3, 10, step=1)
    elif case == "ladder":
        jl, tl = _ladders(model, "topk_block", block=16)
        slo = dict(tpot_p95=1e6, max_queue=1, dwell=2, hysteresis=0.25)
        jc = JEngineConfig(slo=JSLOConfig(**slo), **base)
        tc = EngineConfig(slo=SLOConfig(**slo), **base)
        jkw, tkw = dict(ladder=jl), dict(ladder=tl)
        prompts = _prompts(cfg, 8, 10, step=9)
    elif case == "spec":
        jl, tl = _ladders(model, "topk_shared")
        jc = JEngineConfig(spec=JSpecConfig(gamma=2, drafter_rung=1,
                                            adaptive=True, gamma_min=1,
                                            gamma_max=3, dwell=2), **base)
        tc = EngineConfig(spec=SpecConfig(gamma=2, drafter_rung=1,
                                          adaptive=True, gamma_min=1,
                                          gamma_max=3, dwell=2), **base)
        jkw, tkw = dict(ladder=jl), dict(ladder=tl)
        prompts = [_prompts(cfg, 1, n, step=i)[0]
                   for i, n in enumerate((9, 14, 20, 11))]
    elif case == "prefix":
        kw = dict(max_slots=2, max_len=24, prefill_chunk=8,
                  prefix_cache=True, prefix_cache_tokens=32)
        jc, tc = JEngineConfig(**kw), EngineConfig(**kw)
        a = _prompts(cfg, 1, 12, step=20)[0]
        others = [_prompts(cfg, 1, 12, step=21 + i)[0] for i in range(3)]
        hit = np.concatenate([a[:10], others[0][:3]])
        prompts = [a, hit, *others, a]
    elif case == "preempt":
        jc = JEngineConfig(scheduler=JSchedulerConfig(preemption=True),
                           **base)
        tc = EngineConfig(scheduler=SchedulerConfig(preemption=True), **base)
        prompts = _prompts(cfg, 3, 12, step=5)
    else:                                           # admission
        kw = dict(base, max_slots=1)
        jc = JEngineConfig(scheduler=JSchedulerConfig(max_queue=2), **kw)
        tc = EngineConfig(scheduler=SchedulerConfig(max_queue=2), **kw)
        prompts = _prompts(cfg, 3, 10, step=2)
    return (lambda tel: JEngine(model["jparams"], jcfg, jc, telemetry=tel,
                                **jkw),
            lambda tel: Engine(model["params"], cfg, tc, device="cpu",
                               telemetry=tel, **tkw),
            prompts)


# the events each case must produce (on the JAX side too), so the
# comparison is not vacuous
_CASE_EVENTS = {"plain": set(), "ladder": {"rung_switch"},
                "spec": {"kv_rollback"}, "prefix": {"prefix_evict"},
                "preempt": {"preempt", "resume"}, "admission": {"reject"}}


@pytest.mark.parametrize("case", list(_CASE_EVENTS))
def test_engine_telemetry_equals_jax(model, case):
    jmake, tmake, prompts = _engines(model, case)
    jtel, ttel = _full(jobs), _full(obs)
    jeng, teng, bare = jmake(jtel), tmake(ttel), tmake(None)
    jout = _run_case(jeng, case, prompts)
    tout = _run_case(teng, case, prompts)
    assert tout == jout
    assert _run_case(bare, case, prompts) == tout   # telemetry: no token
    assert bare.obs is obs.NULL_TELEMETRY
    assert _events(ttel) == _events(jtel)
    assert _CASE_EVENTS[case] <= {e["kind"] for e in _events(jtel)}
    builds = ttel.events.events("compile")
    assert builds and not any(e["after_warmup"] for e in builds)
    assert {e["phase"] for e in builds} <= {"decode", "chunk", "verify"}
    assert _spans(ttel) == _spans(jtel)
    ttypes, tsamples = _exposition(teng)
    jtypes, jsamples = _exposition(jeng)
    assert ttypes == jtypes and set(tsamples) == set(jsamples)
    assert _counts(ttypes, tsamples) == _counts(jtypes, jsamples)
    assert obs.validate_exposition(teng.metrics_exposition()) > 0
    tsnap, jsnap = teng.snapshot(), jeng.snapshot()
    assert list(tsnap) == list(jsnap)
    assert tsnap["schema_version"] == SNAPSHOT_SCHEMA_VERSION == 7
    assert {k: v for k, v in tsnap.items() if k not in SNAPSHOT_SKIP} == \
        {k: v for k, v in jsnap.items() if k not in SNAPSHOT_SKIP}
    assert teng.stats.summary().keys() == jeng.stats.summary().keys()


def test_request_hooks_fire_like_jax(model):
    """on_token per emitted token and on_finish once per request (expiry
    included), in the JAX engine's order."""
    _, tmake, prompts = _engines(model, "admission")
    jmake = _engines(model, "admission")[0]
    seen = []
    for make in (jmake, tmake):
        log = []
        eng = make(None)
        for i, kw in enumerate((dict(arrival_time=obs.now() - 10.0,
                                     queue_deadline_s=1.0), {})):
            eng.submit(prompts[i], 4,
                       on_token=lambda rid, tok: log.append(("tok", rid, tok)),
                       on_finish=lambda rs: log.append(
                           ("fin", rs.request.request_id,
                            rs.finish_reason.value)), **kw)
        eng.run()
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[1][0] == ("fin", 0, "expired") and seen[1][-1][0] == "fin"
    assert sum(1 for e in seen[1] if e[0] == "tok") == 4


def test_null_telemetry_allocates_nothing(model):
    t = obs.NULL_TELEMETRY
    assert not t.enabled and t.annotate("x") is t.annotate("y")
    assert t.annotate("x") is obs.NULL_CONTEXT
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        max_slots=2, max_len=32, prefill_chunk=8), device="cpu")
    assert eng.obs is obs.NULL_TELEMETRY
    assert "telemetry_events" not in eng.snapshot()
    full = obs.Telemetry.full()
    assert full.enabled and full.annotate_dispatch and full.profiler is None


def test_close_flushes_trace_sink_even_after_an_exception(model, tmp_path):
    cfg = EngineConfig(max_slots=2, max_len=32, prefill_chunk=8)
    prompt = _prompts(model["cfg"], 1, 8)[0]
    sink = str(tmp_path / "ok.json")
    tel = obs.Telemetry(tracer=obs.SpanTracer(), trace_sink=sink)
    with Engine(model["params"], model["cfg"], cfg, device="cpu",
                telemetry=tel) as eng:
        eng.submit(prompt, 3)
        eng.run()
    with open(sink) as f:
        assert obs.validate_chrome_trace(json.load(f)) > 0
    eng.close()                               # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(prompt, 3)
    assert eng.states[0].tokens               # state stays readable
    sink = str(tmp_path / "boom.json")
    events = str(tmp_path / "boom.jsonl")
    tel = obs.Telemetry(tracer=obs.SpanTracer(), trace_sink=sink,
                        events=obs.EventLog(sink=events))
    with pytest.raises(RuntimeError, match="boom"), \
            Engine(model["params"], model["cfg"], cfg, device="cpu",
                   telemetry=tel) as eng:
        eng.submit(prompt, 3)
        eng.run()
        raise RuntimeError("boom")
    with open(sink) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"submit", "finish", "decode_step"} <= names
    with open(events) as f:
        assert [json.loads(ln)["kind"] for ln in f] == ["compile", "compile"]


def test_reset_ids_gives_a_fresh_namespace(model):
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        max_slots=2, max_len=32, prefill_chunk=8), device="cpu")
    prompts = _prompts(model["cfg"], 2, 8)
    assert eng.submit(prompts[0], 2).request.request_id == 0
    with pytest.raises(RuntimeError, match="busy engine"):
        eng.reset_ids()
    first = eng.run()
    eng.reset_ids()
    assert eng.states == {}
    assert eng.submit(prompts[0], 2).request.request_id == 0
    assert eng.run() == first


def test_profiler_session_window_and_annotations(model, tmp_path):
    """start/stop are idempotent, the window exports a Chrome trace into
    the directory, and the engine's dispatch ranges are in it."""
    tel = obs.Telemetry.full(profile_dir=str(tmp_path / "prof"))
    prof = tel.profiler
    assert prof.stop() is False               # not started
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        max_slots=2, max_len=32, prefill_chunk=8), device="cpu",
        telemetry=tel)
    assert prof.start() and prof.start()
    eng.submit(_prompts(model["cfg"], 1, 8)[0], 3)
    eng.run()
    assert prof.stop() and not prof.stop()
    assert prof.error is None and prof.windows == 1
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"repro/decode", "repro/prefill_chunk"} <= names
    eng.close()


def test_quality_and_flight_rows_equal_jax(model):
    """A ladder engine with full telemetry, the quality monitor and the
    flight recorder, beside the JAX engine: tokens, events and spans
    equal (quality probes and a drift edge included), the exposition's
    ``repro_quality_*`` and ``repro_flight_*`` series equal JAX's with
    equal values but for the roofline count and the recon error sums (the
    port counts FLOPs and bytes itself; the sums agree to rtol 1e-4), and
    the snapshot's v7 quality and flight keys equal JAX's."""
    jl, tl = _ladders(model, "topk_block", block=16)
    kw = dict(max_slots=2, max_len=32, prefill_chunk=8, initial_rung=1)
    qkw = dict(probe_rate=0.5, recon_every=1, recon_window=8,
               saliency_topk=8, drift_threshold=0.9, drift_alpha=1.0)
    jtel = jobs.Telemetry(tracer=jobs.SpanTracer(), events=jobs.EventLog(),
                          quality=jobs.QualityMonitor(**qkw),
                          flight=jobs.FlightRecorder())
    ttel = obs.Telemetry(tracer=obs.SpanTracer(), events=obs.EventLog(),
                         quality=obs.QualityMonitor(**qkw),
                         flight=obs.FlightRecorder())
    jeng = JEngine(model["jparams"], model["jcfg"], JEngineConfig(**kw),
                   ladder=jl, telemetry=jtel)
    teng = Engine(model["params"], model["cfg"], EngineConfig(**kw),
                  device="cpu", ladder=tl, telemetry=ttel)
    prompts = _prompts(model["cfg"], 3, 10, step=3)
    outs = []
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, 8)
        outs.append(eng.run())
    assert outs[1] == outs[0]
    assert _events(ttel) == _events(jtel)
    assert "saliency_drift" in {e["kind"] for e in _events(ttel)}
    assert _spans(ttel) == _spans(jtel)
    assert {e["phase"] for e in ttel.events.events("compile")} >= {
        "quality_probe", "quality_recon"}
    ttypes, tsamples = _exposition(teng)
    jtypes, jsamples = _exposition(jeng)
    assert ttypes == jtypes and set(tsamples) == set(jsamples)
    rows = [k for k in tsamples
            if k[0].startswith(("repro_quality_", "repro_flight_"))]
    assert any(k[0].startswith("repro_flight_") for k in rows)
    for k in rows:
        if "roofline" in k[0] or "utilization" in k[0]:
            assert tsamples[k] > 0
        elif k[0].startswith("repro_quality_recon_error") and \
                k[0].endswith("_sum"):
            assert tsamples[k] == pytest.approx(jsamples[k], rel=1e-4)
        else:
            assert tsamples[k] == jsamples[k], k
    tsnap, jsnap = teng.snapshot(), jeng.snapshot()
    assert list(tsnap) == list(jsnap)
    keys = [k for k in tsnap if k.startswith(("quality_", "flight_"))]
    assert {"quality_probes", "quality_pressure", "flight_records",
            "flight_dropped", "flight_dumps"} <= set(keys)
    for k in keys:
        if k in ("quality_recon_mean", "quality_recon_vs_baseline"):
            assert tsnap[k] == pytest.approx(jsnap[k], rel=1e-3)
        else:
            assert tsnap[k] == jsnap[k], k
    teng.close()
    jeng.close()
