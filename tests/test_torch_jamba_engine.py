"""The port's engine on reduced jamba_v01_52b against the JAX engine:
whole-prompt prefill of ragged prompts (the hybrid has ``mamba`` layers,
so ``auto`` resolves to ``whole``), then batched decode with a free slot,
under ``off``, ``mask`` and ``pallas`` (the trace and the check of
``tests/test_torch_ssm_engine.py``, ``check_tokens``).  The port's
counterpart of ``tests/test_serving.py::test_moe_and_ssm_archs_serve_sparse``
on the hybrid: MoE expert projections and SSM mixers in one stack.
"""
import importlib.util
import pathlib

import pytest

from repro_torch.launch import serve
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "ssm_engine_checks",
    pathlib.Path(__file__).resolve().parent / "test_torch_ssm_engine.py")
ssm_engine_checks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ssm_engine_checks)


@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
def test_jamba_engine_tokens_equal_jax(backend):
    ssm_engine_checks.check_tokens("jamba_v01_52b", backend)


def test_serve_cli_runs_reduced_jamba(capsys):
    out = serve.main(["--arch", "jamba_v01_52b", "--reduced", "--device",
                      "cpu", "--mode", "pallas", "--batch", "2",
                      "--prompt-len", "17", "--gen", "3"])
    assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())
    assert "generated 6 tokens" in capsys.readouterr().out
