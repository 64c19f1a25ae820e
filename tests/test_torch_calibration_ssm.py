"""WiSparse calibration over SSM layers (reduced mamba2_130m: 2 mamba
layers of six projections each, no FFN) against the JAX package: the
capture of the mamba input and output projections, Eq. 7 thresholds,
Alg. 1-4, the npz policy artifact both ways with the engines' greedy
tokens (whole-prompt prefill), and ``calibrate_ladder``.  Models, data
and tolerances: ``tests/torch_calib_parity.py``."""
import pytest

import torch_calib_parity as C
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ARCH = "mamba2_130m"
MAMBA_KEYS = ["mamba/in_B", "mamba/in_C", "mamba/in_dt", "mamba/in_x",
              "mamba/in_z", "mamba/out_proj"]


@pytest.fixture(scope="module")
def m():
    return C.model(ARCH)


def test_build_context_matches(m):
    C.check_build_context(m)
    tctx = m["tctx"]
    assert all(v == MAMBA_KEYS for v in tctx.keys_by_depth.values())
    assert not C.expert_keys(tctx)
    T = m["toks"].size
    assert all(x.shape[0] == T for x in tctx.acts.values())


def test_tau_for_matches(m):
    C.check_tau_for(m)


def test_block_mse_and_fitness_match(m):
    C.check_evaluators(m)


def test_run_pipeline_matches(m):
    C.check_pipeline(m)


def test_policy_from_plan_matches(m):
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
