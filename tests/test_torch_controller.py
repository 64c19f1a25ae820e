"""The port's ladder serving against the JAX package: the SLO controller
(a copy of host code) on random load traces, and the ladder engine on
the reduced llama31_8b with JAX-initialised weights.

The controller-driven trace is ``tests/test_controller.py``'s: 8
requests of 10 tokens into 2 slots, 10 new tokens each, under
``SLOConfig(tpot_p95=1e6, max_queue=1, dwell=2, hysteresis=0.25)``.
With the TPOT target out of reach the controller acts on queue depth
alone, so its transitions are deterministic and must be equal, step
for step, in both packages.  Ladders are ``PolicyLadder.uniform`` at
budgets (0.0, 0.5) with ``block=16``; a ``pallas`` ladder's sp trees get
``tau=-inf`` on both sides (the reference's uncalibrated ``+inf`` zeroes
every ``pallas`` projection).  On the CPU ``pallas`` runs the kernels'
plain versions.  Greedy tokens, per-token rungs and transitions are
compared for exact equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticLM
from repro.models import api as japi
from repro.serving import AdaptiveController as JController
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SLOConfig as JSLOConfig
from repro.sparsity import PolicyLadder as JLadder
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import params as P
from repro_torch.serving import (AdaptiveController, Engine, EngineConfig,
                                 SLOConfig)
from repro_torch.sparsity import PolicyLadder

SLO = dict(tpot_p95=1e6, max_queue=1, dwell=2, hysteresis=0.25)
TRACE = dict(max_slots=2, max_len=32, prefill_chunk=8)


# ---------------------------------------------------------------------------
# the controller on plain numbers
# ---------------------------------------------------------------------------

def _drive(ctrl, trace):
    rungs = [ctrl.update(gaps, queue_depth=q, occupancy=occ)
             for gaps, q, occ in trace]
    return rungs, ctrl.transitions, ctrl.residency, ctrl.snapshot()


_trace = st.lists(st.tuples(
    st.lists(st.floats(0.0, 3.0, allow_nan=False), max_size=4),
    st.integers(0, 12), st.integers(0, 8)), min_size=1, max_size=120)


@settings(max_examples=250, deadline=None)
@given(trace=_trace, num_rungs=st.integers(1, 5), data=st.data())
def test_controller_transitions_equal_jax(trace, num_rungs, data):
    slo = dict(tpot_p95=data.draw(st.floats(0.05, 2.0)),
               max_queue=data.draw(st.integers(0, 6)),
               ewma_alpha=data.draw(st.floats(0.05, 1.0)),
               hysteresis=data.draw(st.floats(0.0, 0.9)),
               dwell=data.draw(st.integers(1, 8)),
               estimate_ttl=data.draw(st.integers(1, 60)))
    initial = data.draw(st.integers(0, num_rungs - 1))
    got = _drive(AdaptiveController(num_rungs, SLOConfig(**slo), initial),
                 trace)
    want = _drive(JController(num_rungs, JSLOConfig(**slo), initial), trace)
    assert got == want


@pytest.mark.parametrize("kw,match", [
    (dict(tpot_p95=0.0), "tpot_p95"), (dict(tpot_p95=1.0, hysteresis=1.0),
                                       "hysteresis"),
    (dict(tpot_p95=1.0, dwell=0), "dwell"),
    (dict(tpot_p95=1.0, ewma_alpha=0.0), "ewma_alpha")])
def test_slo_validation_matches_jax(kw, match):
    for cls in (SLOConfig, JSLOConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_controller_validation():
    with pytest.raises(ValueError, match="initial_rung"):
        AdaptiveController(2, SLOConfig(tpot_p95=1.0), initial_rung=5)
    with pytest.raises(ValueError, match="at least one rung"):
        AdaptiveController(0, SLOConfig(tpot_p95=1.0))


# ---------------------------------------------------------------------------
# the ladder engine
# ---------------------------------------------------------------------------

def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


def _ladders(jparams, jcfg, backend):
    """The same uniform ladder in both packages (the port's carried
    across from JAX's, leaf for leaf)."""
    jl = JLadder.uniform(jparams, jcfg, budgets=(0.0, 0.5), backend=backend,
                         block=16)
    if backend == "pallas":
        jl = JLadder(budgets=jl.budgets, policies=jl.policies,
                     sps=tuple(_with_tau(sp, -jnp.inf) for sp in jl.sps))
    tl = PolicyLadder(
        budgets=jl.budgets,
        policies=tuple(_tpolicy(p) for p in jl.policies),
        sps=tuple(P.from_numpy(jax.tree_util.tree_map(np.asarray, sp))
                  for sp in jl.sps))
    return jl, tl


def _tpolicy(jpol):
    from repro_torch.sparsity import SparsityPolicy
    return SparsityPolicy.from_dict(jpol.to_dict())


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    params = P.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ladders = {b: _ladders(jparams, jcfg, b)
               for b in ("topk_block", "pallas")}
    return dict(jcfg=jcfg, jparams=jparams, params=params,
                cfg=reduced(get_config("llama31_8b")), ladders=ladders)


def _prompts(cfg, n, seq, step=0):
    return np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, n)).batch(step))


def _run(eng, prompts, gen):
    for p in prompts:
        eng.submit(p, gen)
    return eng.run()


@pytest.mark.parametrize("backend", ["topk_block", "pallas"])
def test_controller_trace_equals_jax(model, backend):
    """Queue pressure drives both engines up the ladder and the drain
    brings them back: same tokens, same rung per token, same
    (step, from, to, reason) transitions, no decode build after warmup."""
    jl, tl = model["ladders"][backend]
    prompts = _prompts(model["cfg"], 8, 10, step=9)
    jeng = JEngine(model["jparams"], model["jcfg"],
                   JEngineConfig(slo=JSLOConfig(**SLO), **TRACE), ladder=jl)
    teng = Engine(model["params"], model["cfg"],
                  EngineConfig(slo=SLOConfig(**SLO), **TRACE), ladder=tl,
                  device="cpu")
    assert teng.decode_retraces_after_warmup == 0
    assert teng.decode_graphs.builds == 2
    jout, tout = _run(jeng, prompts, 10), _run(teng, prompts, 10)
    assert tout == jout
    assert all(len(t) == 10 for t in tout.values())
    for rid, rs in teng.states.items():
        assert rs.token_rungs == jeng.states[rid].token_rungs
        assert len(rs.token_rungs) == len(rs.tokens)
    tc, jc = teng.controller, jeng.controller
    assert tc.transitions == jc.transitions
    assert tc.residency == jc.residency
    reasons = [t[3] for t in tc.transitions]
    assert "queue" in reasons and "idle" in reasons
    assert sum(1 for r in tc.residency if r > 0) >= 2
    assert teng.rung == 0 and teng.decode_retraces_after_warmup == 0
    assert sum(teng.decode_graphs.steps) == teng.stats.decode_steps


@pytest.mark.parametrize("rung", [0, 1])
def test_pinned_rung_equals_jax_fixed_policy_engine(model, rung):
    """A ladder engine pinned at a rung emits the JAX fixed-policy
    engine's greedy tokens for that rung's (policy, sp)."""
    jl, tl = model["ladders"]["pallas"]
    prompts = _prompts(model["cfg"], 3, 12, step=5)
    jpol, jsp = jl.rung(rung)
    jout = _run(JEngine(model["jparams"], model["jcfg"],
                        JEngineConfig(policy=jpol, **TRACE), jsp), prompts, 6)
    eng = Engine(model["params"], model["cfg"],
                 EngineConfig(initial_rung=rung, **TRACE), ladder=tl,
                 device="cpu")
    assert eng.rung == rung and eng.controller is None
    assert eng.decode_retraces_after_warmup is None
    tout = _run(eng, prompts, 6)
    assert tout == jout
    assert all(rs.token_rungs == [rung] * 6 for rs in eng.states.values())
    assert eng.decode_graphs.builds == 1          # only the pinned rung


def test_set_rung_switches_without_a_build(model):
    _, tl = model["ladders"]["topk_block"]
    eng = Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
                 ladder=tl, device="cpu")
    eng.warmup()
    prompts = _prompts(model["cfg"], 2, 10, step=3)
    for p in prompts:
        eng.submit(p, 8)
    while eng.scheduler.has_work():
        if eng.step() == "decode":
            eng.set_rung(1 - eng.rung)
    assert eng.decode_retraces_after_warmup == 0
    assert all(g > 0 for g in eng.decode_graphs.steps)
    assert eng.policy == tl.policies[eng.rung] and eng.sp is tl.sps[eng.rung]
    with pytest.raises(ValueError, match="outside"):
        eng.set_rung(2)


def test_ladder_engine_rejects_bad_wiring(model):
    _, tl = model["ladders"]["topk_block"]
    params, cfg = model["params"], model["cfg"]
    with pytest.raises(ValueError, match="not both"):
        Engine(params, cfg, EngineConfig(), sp=tl.sps[1], ladder=tl,
               device="cpu")
    with pytest.raises(ValueError, match="outside"):
        Engine(params, cfg, EngineConfig(initial_rung=7), ladder=tl,
               device="cpu")
    with pytest.raises(ValueError, match="needs a PolicyLadder"):
        Engine(params, cfg, EngineConfig(slo=SLOConfig(tpot_p95=1.0)),
               device="cpu")
    with pytest.raises(ValueError, match="needs a\n?.*PolicyLadder"):
        Engine(params, cfg, EngineConfig(initial_rung=1), device="cpu")
    with pytest.raises(TypeError, match="PolicyLadder"):
        Engine(params, cfg, EngineConfig(), ladder=object(), device="cpu")
    with pytest.raises(TypeError, match="SLOConfig"):
        EngineConfig(slo=object())


def test_warmup_refuses_busy_engine(model):
    _, tl = model["ladders"]["topk_block"]
    eng = Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
                 ladder=tl, device="cpu")
    eng.warmup()                              # idle: fine
    eng.submit(_prompts(model["cfg"], 1, 10)[0], 4)
    with pytest.raises(RuntimeError, match="busy"):
        eng.warmup()
    eng.run()
    eng.warmup()                              # drained again: fine
    assert eng.decode_retraces_after_warmup == 0


def test_serve_cli_serves_a_ladder(model, tmp_path, capsys):
    jl, _ = model["ladders"]["topk_block"]
    path = str(tmp_path / "ladder.npz")
    jl.save(path)
    out = serve.main(["--reduced", "--device", "cpu", "--ladder", path,
                      "--slo-tpot-p95", "1000", "--slo-max-queue", "0",
                      "--batch", "2", "--prompt-len", "10", "--gen", "4"])
    text = capsys.readouterr().out
    assert "loaded 2-rung ladder" in text and "controller:" in text
    assert sorted(out) == [0, 1] and all(len(t) == 4 for t in out.values())
    with pytest.raises(SystemExit, match="out of range"):
        serve.main(["--reduced", "--device", "cpu", "--ladder", path,
                    "--rung", "2", "--batch", "1", "--prompt-len", "8",
                    "--gen", "2"])


@pytest.mark.parametrize("argv,match", [
    (["--slo-tpot-p95", "0.1"], "needs --ladder"),
    (["--rung", "1"], "needs --ladder"),
    (["--rung", "-1"], "--rung must be"),
    (["--ladder", "x.npz", "--calib-quick"], "drop"),
    (["--ladder", "x.npz", "--policy-artifact", "y.npz"], "drop")])
def test_serve_cli_ladder_flag_validation(argv, match):
    args = serve.build_parser().parse_args(argv)
    with pytest.raises(SystemExit, match=match):
        serve.validate_args(args)
