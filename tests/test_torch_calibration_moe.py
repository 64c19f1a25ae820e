"""WiSparse calibration over MoE layers (reduced granite_moe_1b_a400m:
4 experts, top-2, 2 layers of attention and a MoE FFN) against the JAX
package: the per-expert capture and column norms, the top-k-scaled
block budgets, Eq. 7 thresholds shared by a layer's experts, Alg. 1-4,
the npz policy and ladder artifacts both ways with the engines' greedy
tokens, and a calibrated ladder under the SLO controller.  Models,
data and tolerances: ``tests/torch_calib_parity.py``."""
import numpy as np
import pytest

import torch_calib_parity as C
from torch_threads import one_thread_module  # noqa: F401 (autouse)
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SLOConfig as JSLOConfig
from repro.sparsity import PolicyLadder as JLadder
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.serving import Engine, EngineConfig, SLOConfig
from repro_torch.sparsity import PolicyLadder

ARCH = "granite_moe_1b_a400m"
# tests/test_torch_controller.py's controller trace: 8 requests of 10
# tokens into 2 slots, the TPOT target out of reach, so the controller
# acts on queue depth alone
SLO = dict(tpot_p95=1e6, max_queue=1, dwell=2, hysteresis=0.25)
SLO_TRACE = dict(max_slots=2, max_len=32, prefill_chunk=8)


@pytest.fixture(scope="module")
def m():
    return C.model(ARCH)


def test_build_context_matches(m):
    C.check_build_context(m)
    keys = C.expert_keys(m["tctx"])
    cfg = m["cfg"]
    assert [k[1] for k in keys[:3]] == ["moe/wi_gate", "moe/wi_up", "moe/wo"]
    E = cfg.num_experts_padded
    for k in keys:
        x, g = m["tctx"].acts[k], m["tctx"].g[k]
        assert x.shape[0] == g.shape[0] == E and x.shape[2] == g.shape[1]
        w = m["params"]["groups"][0]["l0"]["moe"][k[1].split("/")[1]]
        assert m["tctx"].sizes[k] == float(cfg.num_experts_per_tok
                                           * w.shape[-2] * w.shape[-1])


def test_tau_for_matches(m):
    C.check_tau_for(m)


def test_block_mse_and_fitness_match(m):
    C.check_evaluators(m)


def test_run_pipeline_matches(m):
    C.check_pipeline(m)


def test_policy_from_plan_matches(m):
    """``k_max_frac`` of the MoE plan equals the reference's (1.0 here:
    some layer keeps every channel, so ``pallas`` reads every weight
    block and only the rank mask sparsifies), and the sensitive-block
    backend resolves alike on ``attn/*`` and ``moe/*`` roles."""
    C.check_policy(m)


@pytest.mark.parametrize("backend", ["mask", "pallas"])
@pytest.mark.parametrize("calibrated_by", ["jax", "port"])
def test_artifact_serves_the_same_tokens(m, backend, calibrated_by,
                                         tmp_path):
    out = C.check_artifact_tokens(m, backend, calibrated_by, tmp_path)
    assert len({t for ts in out.values() for t in ts}) > 1


def test_artifact_versions_carry_the_leaves(m, tmp_path):
    C.check_artifact_versions(m, tmp_path)


def test_calibrate_ladder_matches(m, tmp_path):
    C.check_calibrate_ladder(m, tmp_path)


def test_calibrated_ladder_under_the_slo_controller(m, tmp_path):
    """The JAX-calibrated (0.0, 0.5) ``pallas`` ladder, saved as the
    ladder artifact and loaded by each package, served under the SLO
    controller: the same tokens, rung per token and transitions."""
    jl, _ = C.ladders(m)
    path = str(tmp_path / "ladder.npz")
    jl.save(path)
    jladder, tladder = JLadder.load(path), PolicyLadder.load(path)
    prompts = np.asarray(SyntheticLM(DataConfig(
        m["cfg"].vocab_size, 10, 8)).batch(9))
    jeng = JEngine(m["jparams"], m["jcfg"],
                   JEngineConfig(slo=JSLOConfig(**SLO), **SLO_TRACE),
                   ladder=jladder)
    teng = Engine(m["params"], m["cfg"],
                  EngineConfig(slo=SLOConfig(**SLO), **SLO_TRACE),
                  ladder=tladder, device="cpu")
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, 10)
    jout, tout = jeng.run(), teng.run()
    assert tout == jout and all(len(t) == 10 for t in tout.values())
    for rid, rs in teng.states.items():
        assert rs.token_rungs == jeng.states[rid].token_rungs
    tc, jc = teng.controller, jeng.controller
    assert tc.transitions == jc.transitions
    assert tc.residency == jc.residency
    assert {"queue", "idle"} <= {t[3] for t in tc.transitions}
    assert teng.decode_retraces_after_warmup == 0
