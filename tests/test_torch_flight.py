"""The port's flight recorder, injectable clock and replay against the
JAX package's (``tests/test_flight.py``), on the reduced llama31_8b (f32)
with JAX-initialised weights carried by ``models/params.from_numpy`` and
JAX's uniform ladder [0.0, 0.5, 0.7] carried by the ladder artifact.

- Null path: ``engine.clock is SYSTEM_CLOCK`` and the telemetry is
  ``NULL_TELEMETRY``; recorder validation and double attach as JAX's.
- ``ReplayClock``: each divergence (exhausted, record kind, call site)
  raises with JAX's message and ``detail``, case by case.
- The same scripted clock driving a JAX and a port engine through the
  same scenario gives equal record streams (the header's fingerprints
  too: they hash the same bytes), and the clock sites the port reads are
  the reference's 16 tags.
- Record -> replay is bit-identical for the controller with preemption,
  a speculative round and a prefix cache with evictions; a header-only
  replay (no factory) works; an overflowed ring dump is refused; the
  SLO-breach and exception dumps fire; the sink is sealed and
  versioned; the injected-divergence CLI prints a structured report.
- A recording written by the JAX engine replays through the port's
  ``replay`` with a factory over the carried weights and ladder, ``ok``.
"""
import glob
import json
import os

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticLM
from repro.models import api as japi
from repro.obs.flight import FlightRecorder as JFlightRecorder
from repro.obs.flight import replay as jreplay
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import SLOConfig as JSLOConfig
from repro.serving import SpecConfig as JSpecConfig
from repro.sparsity import PolicyLadder as JLadder
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.obs import (NULL_TELEMETRY, ReplayClock, ReplayDivergence,
                             Telemetry)
from repro_torch.obs.flight import FLIGHT_SCHEMA_VERSION, FlightRecorder
from repro_torch.obs.flight import replay as flight_replay
from repro_torch.serving import (Engine, EngineConfig, SchedulerConfig,
                                 SLOConfig, SpecConfig)
from repro_torch.sparsity import PolicyLadder
from torch_threads import one_thread_module  # noqa: F401 (autouse)

# the reference's engine clock sites (src/repro/serving/engine.py, spec.py)
SITES = {"submit.arrival", "admit.sweep", "prefill_chunk.t0",
         "prefill_chunk.t1", "prefill_whole.t0", "prefill_whole.t1",
         "first_token", "decode.t0", "decode.t1", "preempt", "resume",
         "finish", "spec.t0", "spec.t1", "spec.t2", "spec.t3"}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    jladder = JLadder.uniform(jparams, jcfg, [0.0, 0.5, 0.7])
    path = str(tmp_path_factory.mktemp("ladder") / "ladder.npz")
    jladder.save(path)
    return dict(jcfg=jcfg, jparams=jparams, jladder=jladder,
                ladder_path=path,
                cfg=reduced(get_config("llama31_8b")),
                params=P.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams)),
                ladder=PolicyLadder.load(path, device="cpu"))


def _prompts(cfg, n, seq, step=0):
    return np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, n)).batch(step))


class ScriptedClock:
    """A deterministic clock: the n-th read returns ``t0 + n * dt``, in
    both packages alike."""

    def __init__(self, t0=100.0, dt=0.004):
        self.t, self.dt = t0, dt

    def now(self, site=""):
        self.t += self.dt
        return self.t


def _controller_kw():
    return dict(max_slots=2, max_len=96, prefill_chunk=16)


def _controller_ecfg():
    return EngineConfig(
        slo=SLOConfig(tpot_p95=1e-9, max_queue=2),
        scheduler=SchedulerConfig(max_queue=8, preemption=True),
        **_controller_kw())


def _jcontroller_ecfg():
    return JEngineConfig(
        slo=JSLOConfig(tpot_p95=1e-9, max_queue=2),
        scheduler=JSchedulerConfig(max_queue=8, preemption=True),
        **_controller_kw())


def _drive_controller(eng, prompts):
    """The incident scenario of ``tests/test_flight.py``: an impossible
    TPOT SLO forces rung escalation while an interactive arrival
    preempts a best-effort decoder."""
    for i in range(2):
        eng.submit(prompts[i], 24, priority="best-effort")
    for _ in range(10):
        eng.step()
    eng.submit(prompts[2], 12, priority="interactive")
    while eng.scheduler.has_work():
        eng.step()


def _record_controller_run(model, sink, dump_dir=None, clock=None):
    fr = FlightRecorder(sink=sink, dump_dir=dump_dir)
    with Engine(model["params"], model["cfg"], _controller_ecfg(),
                ladder=model["ladder"], device="cpu",
                telemetry=Telemetry(flight=fr), clock=clock) as eng:
        _drive_controller(eng, _prompts(model["cfg"], 3, 20))
    return fr


def _factory(model, ecfg):
    return lambda clock, telemetry: Engine(
        model["params"], model["cfg"], ecfg, ladder=model["ladder"],
        device="cpu", telemetry=telemetry, clock=clock)


# ---------------------------------------------------------------------------
# null path + construction validation
# ---------------------------------------------------------------------------

def test_null_path_keeps_the_singletons(model):
    assert NULL_TELEMETRY.flight is None
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        max_slots=1, max_len=24, prefill_chunk=8), device="cpu")
    assert eng.obs is NULL_TELEMETRY
    assert eng.clock is obs.SYSTEM_CLOCK
    assert "flight_records" not in eng.snapshot()
    assert "repro_flight_records_total" not in eng.metrics_exposition()


def test_recorder_validation_and_double_attach_like_jax(model):
    kw = dict(max_slots=1, max_len=24, prefill_chunk=8)
    for mod, rec in ((obs, FlightRecorder), (jobs, JFlightRecorder)):
        with pytest.raises(ValueError, match="capacity"):
            rec(capacity=0)
        with pytest.raises(ValueError, match="max_dumps"):
            rec(max_dumps=-1)
    with pytest.raises(TypeError, match="now"):
        Engine(model["params"], model["cfg"], EngineConfig(**kw),
               device="cpu", clock=object())
    fr = FlightRecorder()
    eng = Engine(model["params"], model["cfg"], EngineConfig(**kw),
                 device="cpu", telemetry=Telemetry(flight=fr))
    assert eng.clock is not obs.SYSTEM_CLOCK      # the recording wrapper
    with pytest.raises(RuntimeError, match="already attached"):
        Engine(model["params"], model["cfg"], EngineConfig(**kw),
               device="cpu", telemetry=Telemetry(flight=fr))


_CLOCK_CASES = {
    "exhausted": ([{"k": "clock", "t": 1.5, "s": "decode.t0"}],
                  ["decode.t0", "decode.t1"]),
    "kind": ([{"k": "submit", "prompt": [1]}], ["decode.t0"]),
    "site": ([{"k": "clock", "t": 1.5, "s": "decode.t0"}],
             ["prefill_chunk.t0"]),
    "untagged": ([{"k": "clock", "t": 2.5}], ["decode.t1"]),
}


@pytest.mark.parametrize("case", list(_CLOCK_CASES))
def test_replay_clock_divergences_equal_jax(case):
    """Exhausted stream, record kind and call site each raise a
    ReplayDivergence whose message and ``detail`` are JAX's; a record
    without a site tag matches any site."""
    inputs, reads = _CLOCK_CASES[case]
    outs = []
    for cls, exc_cls in ((ReplayClock, ReplayDivergence),
                         (jobs.ReplayClock, jobs.ReplayDivergence)):
        clock, got = cls(inputs), []
        for site in reads:
            try:
                got.append(clock.now(site))
            except exc_cls as e:
                got.append((str(e), e.detail))
        outs.append((got, clock.cursor, clock.exhausted))
    assert outs[0] == outs[1]
    if case == "kind":
        assert outs[0][1] == 0                # a divergence consumes nothing
    if case == "untagged":
        assert outs[0][0] == [2.5]


def test_wall_clock_mapping_is_the_references():
    t = obs.now()
    assert abs(obs.to_wall(t) - jobs.to_wall(t)) < 1.0
    assert obs.SYSTEM_CLOCK.now("x") >= t


# ---------------------------------------------------------------------------
# the same scripted clock: equal record streams
# ---------------------------------------------------------------------------

def test_record_streams_equal_jax_under_one_scripted_clock(model):
    prompts = _prompts(model["cfg"], 3, 20)
    jfr, tfr = JFlightRecorder(), FlightRecorder()
    with JEngine(model["jparams"], model["jcfg"], _jcontroller_ecfg(),
                 ladder=model["jladder"],
                 telemetry=jobs.Telemetry(flight=jfr),
                 clock=ScriptedClock()) as jeng:
        _drive_controller(jeng, prompts)
    with Engine(model["params"], model["cfg"], _controller_ecfg(),
                ladder=model["ladder"], device="cpu",
                telemetry=Telemetry(flight=tfr),
                clock=ScriptedClock()) as teng:
        _drive_controller(teng, prompts)
    jrec, trec = jfr.records(), tfr.records()
    assert trec == jrec                          # header fingerprints too
    kinds = {r["kind"] for r in trec if r["k"] == "decision"}
    assert {"rung_switch", "preempt", "resume"} <= kinds
    assert {r["s"] for r in trec if r["k"] == "clock"} <= SITES
    assert teng.snapshot()["flight_records"] == tfr.count == jfr.count


def test_spec_and_prefix_clock_sites_are_the_references(model):
    """Every engine clock read carries one of the reference's site tags,
    in the reference's order: spec rounds (``spec.t0``-``t3``) and a
    prefix cache with evictions, under the same scripted clock."""
    spec = dict(gamma=2, drafter_rung=1, verifier_rung=0, adaptive=True)
    kw = dict(max_slots=2, max_len=96, prefill_chunk=16)
    prompts = _prompts(model["cfg"], 2, 20)
    streams = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            fr = JFlightRecorder()
            eng = JEngine(model["jparams"], model["jcfg"], JEngineConfig(
                spec=JSpecConfig(**spec), **kw), ladder=model["jladder"],
                telemetry=jobs.Telemetry(flight=fr), clock=ScriptedClock())
        else:
            fr = FlightRecorder()
            eng = Engine(model["params"], model["cfg"], EngineConfig(
                spec=SpecConfig(**spec), **kw), ladder=model["ladder"],
                device="cpu", telemetry=Telemetry(flight=fr),
                clock=ScriptedClock())
        with eng:
            for p in prompts:
                eng.submit(p, 16)
            eng.run()
        streams.append(fr.records()[1:])
    assert streams[0] == streams[1]
    sites = [r["s"] for r in streams[1] if r["k"] == "clock"]
    assert {"spec.t0", "spec.t1", "spec.t2", "spec.t3"} <= set(sites)
    assert set(sites) <= SITES


# ---------------------------------------------------------------------------
# record -> replay round trips
# ---------------------------------------------------------------------------

def test_controller_preemption_replays_bit_identical(model, tmp_path):
    sink = str(tmp_path / "controller.jsonl")
    fr = _record_controller_run(model, sink)
    kinds = {r["kind"] for r in fr.records("decision")}
    assert "rung_switch" in kinds, "scenario must exercise the controller"
    assert "preempt" in kinds and "resume" in kinds
    report = flight_replay.replay(
        sink, engine_factory=_factory(model, _controller_ecfg()))
    assert report.ok, report.failures
    assert report.divergence is None
    assert report.requests == 3 and report.tokens > 0
    assert report.retraces == {"decode": 0, "chunk": 0}


def test_header_reconstruction_replays_without_factory(model, tmp_path):
    """No factory: the engine is rebuilt from the header alone (arch,
    reduced, seed, ladder path, the serialized EngineConfig) with the
    port's own seeded params."""
    cfg = model["cfg"]
    params = api.init_model(cfg, 0, device="cpu")
    sink = str(tmp_path / "controller.jsonl")
    fr = FlightRecorder(sink=sink, meta={
        "arch": "llama31_8b", "reduced": True, "seed": 0,
        "ladder_path": model["ladder_path"]})
    with Engine(params, cfg, _controller_ecfg(), ladder=model["ladder"],
                device="cpu", telemetry=Telemetry(flight=fr)) as eng:
        eng.submit(_prompts(cfg, 1, 20)[0], 12)
        while eng.scheduler.has_work():
            eng.step()
    report = flight_replay.replay(sink, device="cpu")
    assert report.ok, report.failures


def test_spec_round_replays_bit_identical(model, tmp_path):
    sink = str(tmp_path / "spec.jsonl")
    ecfg = EngineConfig(
        max_slots=2, max_len=96, prefill_chunk=16,
        spec=SpecConfig(gamma=2, drafter_rung=1, verifier_rung=0,
                        adaptive=True))
    fr = FlightRecorder(sink=sink)
    with Engine(model["params"], model["cfg"], ecfg, ladder=model["ladder"],
                device="cpu", telemetry=Telemetry(flight=fr)) as eng:
        for p in _prompts(model["cfg"], 2, 20):
            eng.submit(p, 16)
        while eng.scheduler.has_work():
            eng.step()
    assert fr.records("finish"), "spec scenario recorded no finishes"
    report = flight_replay.replay(sink, engine_factory=_factory(model, ecfg))
    assert report.ok, report.failures
    assert report.retraces.get("verify") == 0


def test_prefix_cache_replays_bit_identical(model, tmp_path):
    """Hits and LRU evictions (a ``prefix_evict`` decision) replay."""
    cfg = model["cfg"]
    sink = str(tmp_path / "prefix.jsonl")
    ecfg = EngineConfig(max_slots=2, max_len=24, prefill_chunk=8,
                        prefix_cache=True, prefix_cache_tokens=32)
    a = _prompts(cfg, 1, 12, step=20)[0]
    others = [_prompts(cfg, 1, 12, step=21 + i)[0] for i in range(3)]
    fr = FlightRecorder(sink=sink)
    with Engine(model["params"], cfg, ecfg, device="cpu",
                telemetry=Telemetry(flight=fr)) as eng:
        for p in [a, np.concatenate([a[:10], others[0][:3]]), *others, a]:
            eng.submit(p, 3)
            eng.run()
    assert "prefix_evict" in {r["kind"] for r in fr.records("decision")}
    report = flight_replay.replay(sink, engine_factory=lambda clock, tel:
                                  Engine(model["params"], cfg, ecfg,
                                         device="cpu", telemetry=tel,
                                         clock=clock))
    assert report.ok, report.failures


def test_a_jax_recording_replays_through_the_port(model, tmp_path):
    """The JAX engine records; the port's replay re-drives a port engine
    over the carried weights and ladder: fingerprints, tokens, rung
    residency and every decision equal."""
    sink = str(tmp_path / "jax.jsonl")
    fr = JFlightRecorder(sink=sink)
    with JEngine(model["jparams"], model["jcfg"], _jcontroller_ecfg(),
                 ladder=model["jladder"],
                 telemetry=jobs.Telemetry(flight=fr)) as eng:
        _drive_controller(eng, _prompts(model["cfg"], 3, 20))
    report = flight_replay.replay(
        sink, engine_factory=_factory(model, _controller_ecfg()))
    assert report.ok, report.failures
    assert report.requests == 3


def test_injected_divergence_cli_reports_structured_diff(model, tmp_path,
                                                         capsys):
    """``--inject-divergence`` corrupts one recorded token; the CLI exits
    1 and names the request, token and record that diverged, with the
    JAX CLI's report keys."""
    cfg = model["cfg"]
    sink = str(tmp_path / "one.jsonl")
    fr = FlightRecorder(sink=sink, meta={
        "arch": "llama31_8b", "reduced": True, "seed": 0,
        "ladder_path": model["ladder_path"]})
    params = api.init_model(cfg, 0, device="cpu")
    with Engine(params, cfg, _controller_ecfg(), ladder=model["ladder"],
                device="cpu", telemetry=Telemetry(flight=fr)) as eng:
        eng.submit(_prompts(cfg, 1, 20)[0], 12)
        while eng.scheduler.has_work():
            eng.step()
    rc = flight_replay.main([sink, "--inject-divergence", "--device", "cpu"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"]
    assert set(report) == set(jreplay.ReplayReport(
        True, [], None, 0, 0, 0, {}).to_dict())
    div = report["divergence"]
    assert {"record", "request", "token_index",
            "recorded_token", "replayed_token"} <= set(div)
    assert div["recorded_token"] == div["replayed_token"] + 1


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

def test_incomplete_ring_dump_is_refused(model, tmp_path):
    dump_dir = str(tmp_path / "dumps")
    fr = _record_controller_run(model, sink=None, dump_dir=dump_dir)
    assert fr.capacity == 4096 and fr.dropped == 0
    small = FlightRecorder(capacity=8, dump_dir=dump_dir)
    small._attached = True
    for rec in fr.records():
        small._append(rec)
    assert small.dropped > 0
    path = small.dump("manual")
    with open(path) as f:
        prologue = json.loads(f.readline())
    assert prologue["complete"] is False
    for load in (flight_replay.load_recording, jreplay.load_recording):
        with pytest.raises(ValueError, match="incomplete"):
            load(path)


def test_dump_triggers_slo_breach_and_exception(model, tmp_path):
    dump_dir = str(tmp_path / "dumps")
    fr = _record_controller_run(model, sink=None, dump_dir=dump_dir)
    reasons = {os.path.basename(p).split("-")[1] for p in fr.dumps}
    assert "slo_breach" in reasons, fr.dumps
    # a complete ring dump loads in both packages
    for load in (flight_replay.load_recording, jreplay.load_recording):
        assert load(fr.dumps[0]).header["k"] == "header"

    fr2 = FlightRecorder(dump_dir=dump_dir)
    with pytest.raises(RuntimeError, match="boom"), \
            Engine(model["params"], model["cfg"], _controller_ecfg(),
                   ladder=model["ladder"], device="cpu",
                   telemetry=Telemetry(flight=fr2)) as eng:
        eng.submit(_prompts(model["cfg"], 1, 20)[0], 12)
        eng.step()
        raise RuntimeError("boom")
    assert any("flight-exception-" in p for p in fr2.dumps)
    assert glob.glob(os.path.join(dump_dir, "flight-exception-*.jsonl"))


def test_sink_is_sealed_and_versioned(model, tmp_path):
    sink = str(tmp_path / "sealed.jsonl")
    _record_controller_run(model, sink)
    with open(sink) as f:
        records = [json.loads(ln) for ln in f]
    assert records[0]["k"] == "header"
    assert records[0]["flight_schema_version"] == FLIGHT_SCHEMA_VERSION \
        == jobs.flight.FLIGHT_SCHEMA_VERSION
    assert records[-1] == {"k": "end", "count": len(records) - 1,
                           "complete": True}
    assert set(records[0]) == {
        "k", "flight_schema_version", "config_fingerprint",
        "params_fingerprint", "ladder_fingerprint", "num_rungs", "ecfg",
        "meta"}
