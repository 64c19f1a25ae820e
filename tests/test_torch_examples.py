"""The port's examples (``repro_torch.examples``, the counterparts of the
JAX package's ``examples/``) run to the end on the CPU: ``quickstart``
and ``calibrate_and_serve`` in process, ``gateway_smoke`` and
``flight_smoke`` as the subprocesses a CI job would start, each with
``--device cpu`` and exit 0.  ``flight_smoke`` decodes 512 best-effort
tokens per request here, where its default is the reference's 1024:
enough to keep both slots busy when the interactive arrival lands."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import calibrate_and_serve, quickstart
from torch_threads import ONE_THREAD_ENV
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_runs(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert np.isfinite(out["kl"]) and 0.0 <= out["agreement"] <= 1.0
    assert np.allclose(out["block_ratios"], 0.5, atol=0.1)
    printed = capsys.readouterr().out
    assert "50% sparsity: KL(dense||sparse)=" in printed
    assert printed.rstrip().endswith("OK")


def test_calibrate_and_serve_runs(capsys):
    out = calibrate_and_serve.main(["--device", "cpu"])
    assert sorted(out["agreement"]) == [1, 2]
    assert all(0.0 <= a <= 1.0 for a in out["agreement"].values())
    assert out["builds_after_warmup"] == 0
    assert out["controller"]["switches"] > 0
    assert sorted(out["tokens"]) == list(range(8))
    assert all(len(t) == 8 for t in out["tokens"].values())
    assert "decode builds after warmup 0" in capsys.readouterr().out


@pytest.mark.parametrize("example", [quickstart, calibrate_and_serve])
def test_examples_need_a_card_unless_asked_for_cpu(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main([])


@pytest.mark.parametrize("argv", [
    ["gateway_smoke"],
    ["flight_smoke", "--gen", "512"]])
def test_smoke_scripts_exit_zero(argv, tmp_path):
    extra = ["--out-dir", str(tmp_path)] if argv[0] == "flight_smoke" else []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **ONE_THREAD_ENV)
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{argv[0]}",
         "--device", "cpu", *argv[1:], *extra], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    if argv[0] == "gateway_smoke":
        assert "SSE stream OK" in proc.stdout
        assert "SIGTERM drain OK (exit 0)" in proc.stdout
    else:
        assert "rung switches + preemption present" in proc.stdout
        assert "divergence report OK" in proc.stdout
