"""WiSparse calibration over the hybrid (reduced jamba_v01_52b: 8
layers, one attention layer among seven mamba layers, a dense MLP or a
MoE FFN after each) against the JAX package: every pattern position's
capture, the expert keys' (E, n) norms and top-k-scaled sizes, Eq. 7
thresholds, Alg. 1-4 with the plan restacked over the mixed pattern,
the npz policy artifact both ways with the engines' greedy tokens under
``mask``, and ``calibrate_ladder``.  The engines serve three prompts of
20 tokens (one whole prefill each), and ``pallas`` engine parity of
calibrated plans is held on granite and mamba2
(``tests/test_torch_calibration_moe.py``, ``_ssm.py``): each JAX
prefill length, and each JAX ``pallas`` engine, is one more trace of 8
layers under the interpreted Pallas kernels, about 20 s each.  Models,
data and tolerances: ``tests/torch_calib_parity.py``."""
import pytest

import torch_calib_parity as C
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ARCH = "jamba_v01_52b"


@pytest.fixture(scope="module")
def m():
    return C.model(ARCH)


def test_build_context_matches(m):
    C.check_build_context(m)
    kinds = {tuple(dl.kind) for dl in m["tctx"].layers}
    assert kinds == {("attn", "dense"), ("mamba", "dense"), ("mamba", "moe")}
    assert C.expert_keys(m["tctx"])


def test_tau_for_matches(m):
    C.check_tau_for(m)


def test_block_mse_and_fitness_match(m):
    C.check_evaluators(m)


def test_run_pipeline_matches(m):
    C.check_pipeline(m)


def test_policy_from_plan_matches(m):
    C.check_policy(m)


@pytest.mark.parametrize("calibrated_by", ["jax", "port"])
def test_artifact_serves_the_same_tokens(m, calibrated_by, tmp_path):
    out = C.check_artifact_tokens(m, "mask", calibrated_by, tmp_path,
                                  lens=(20, 20, 20))
    assert len({t for ts in out.values() for t in ts}) > 1


def test_calibrate_ladder_matches(m, tmp_path):
    C.check_calibrate_ladder(m, tmp_path)
