"""``repro_torch.examples.train_then_sparsify`` against the JAX package's
``examples/train_then_sparsify.py``, both from the JAX init (the port's
``init_model`` patched as ``tests/test_torch_train_follows_jax.py``
patches it): 200 steps of 8 x 96 tokens with a checkpoint every 50 and a
simulated preemption at step 120, then WiSparse at 30/40/50%.

Tolerances: the per-step losses (220 executed, the 20 after the restart
replayed from the step-100 checkpoint) at 1e-4, that file's; every
printed line but the runner's straggler notes (host timing) equal in
its text, and its numbers (held-out loss, ppl, retention, top-1
agreement) within one unit of their last printed digit, the WiSparse
lines on one trained model (the JAX example's, carried across): the
two trainers' weights agree to about 1e-5, not bitwise, so from the
JAX init the WiSparse lines are held at rtol 1e-2.  On one model the
line of :data:`BRANCHES` is held at rtol 1e-2 too: its alpha search
branches apart on an Eq. 7 threshold tie (reference behaviour 4,
``tests/torch_evals_parity.py``), which ``test_branch_is_a_threshold_tie``
shows, holding the JAX plan's metrics in the port at 1e-5."""
import contextlib
import dataclasses
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import eval_metrics as jeval_metrics
from repro.core import calibration as JC
from repro.core import pipeline as JP
from repro.core.allocation import EvoConfig as JEvo
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import api as japi
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.core import pipeline as TP
from repro_torch.evals.common import build_calibration, eval_metrics
from repro_torch.examples import train_then_sparsify
from repro_torch.launch import train as ttrain
from repro_torch.models import params as P
from torch_threads import one_thread_module  # noqa: F401 (autouse)
from torch_evals_parity import assert_metrics_close, assert_threshold_tie

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-4
WISPARSE_RTOL = 1e-2
# the printed lines whose calibration branches apart on a threshold tie,
# on the JAX example's trained weights -> its sparsity
BRANCHES = {"WiSparse@40%": 0.4}
_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?")


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_then_sparsify",
        os.path.join(ROOT, "examples", "train_then_sparsify.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text: str) -> list:
    return [s for s in text.splitlines() if not s.startswith("straggler")]


def _unit(printed: str) -> float:
    return 10.0 ** -(len(printed.split(".")[1]) if "." in printed else 0)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's printed lines and what its ``train`` returned."""
    jmod = _jax_example()
    seen, jax_train = {}, jmod.train

    def jtrain(**kw):
        seen["train"] = jax_train(**kw)
        return seen["train"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "train", jtrain)
        mp.setattr("sys.argv", ["train_then_sparsify.py"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jmod.main()
    return _lines(buf.getvalue()), seen["train"]


def _assert_lines_match(tl, jl, rtol=None):
    """The same lines but for their numbers, which agree within one unit
    of their last printed digit (or within ``rtol``)."""
    assert [_NUM.sub("#", s) for s in tl] == [_NUM.sub("#", s) for s in jl]
    for t, j in zip(tl, jl):
        for a, b in zip(_NUM.findall(t), _NUM.findall(j)):
            lim = _unit(b) if rtol is None else rtol * abs(float(b))
            assert abs(float(a) - float(b)) <= lim * (1 + 1e-9), (t, j)


def test_the_example_follows_the_jax_example(jax_run, monkeypatch, capsys):
    """The whole example from the JAX init: the losses at 1e-4 and the
    trainer's lines to their printed precision.  The two trained models
    agree to about 1e-5, not bitwise, and a search on weights that
    differ can take another near-tied step, so the WiSparse lines are
    held here at rtol 1e-2 (on one model they are held to their printed
    precision below)."""
    jl, (_jparams, jcfg, _, jhist, jfinal) = jax_run
    init = japi.init_model(jcfg, 0)
    monkeypatch.setattr(
        ttrain.api, "init_model",
        lambda cfg, seed, device: P.from_numpy(
            jax.tree_util.tree_map(np.asarray, init), device))
    out = train_then_sparsify.main(["--device", "cpu"])
    tl = _lines(capsys.readouterr().out)

    assert len(out["losses"]) == len(jhist) == 220
    np.testing.assert_allclose(out["losses"], [h["loss"] for h in jhist],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert abs(out["final"] - jfinal) < LOSS_TOL
    assert any("simulated preemption at step 120" in s for s in tl)
    n = next(i for i, s in enumerate(jl) if s.startswith("WiSparse@"))
    _assert_lines_match(tl[:n], jl[:n])
    _assert_lines_match(tl[n:], jl[n:], rtol=WISPARSE_RTOL)
    assert sorted(out["wisparse"]) == [0.3, 0.4, 0.5]
    for m in out["wisparse"].values():
        assert np.isfinite(m["ppl"]) and 0.0 < m["top1_agree"] <= 1.0
        assert m["retention"] == pytest.approx(out["dense"]["ppl"] / m["ppl"])


def test_wisparse_on_the_jax_trained_model(jax_run, monkeypatch, capsys):
    """The example's WiSparse stage on the JAX example's trained weights,
    carried across: every line after training to its printed
    precision."""
    jl, (jparams, jcfg, jdata, jhist, jfinal) = jax_run
    params = P.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    data_cfg = DataConfig(**dataclasses.asdict(jdata))
    cfg = reduced(get_config("llama31_8b"))
    monkeypatch.setattr(
        train_then_sparsify, "train",
        lambda **kw: (params, cfg, data_cfg, jhist, jfinal))
    train_then_sparsify.main(["--device", "cpu"])
    tl = capsys.readouterr().out.splitlines()
    n = next(i for i, s in enumerate(jl) if s.startswith("trained:"))
    assert len(tl) == len(jl[n:])
    for t, j in zip(tl, jl[n:]):
        branched = t.split(":")[0] in BRANCHES
        _assert_lines_match([t], [j], WISPARSE_RTOL if branched else None)


@pytest.mark.parametrize("row", sorted(BRANCHES))
def test_branch_is_a_threshold_tie(jax_run, row):
    """The searches behind :data:`BRANCHES` (the example's calibration at
    that sparsity on the JAX trained weights) branch apart on a
    threshold tie; the JAX plan's metrics in the port agree with JAX's
    at 1e-5."""
    jl, (jparams, jcfg, jdata, _, _) = jax_run
    p = BRANCHES[row]
    params = P.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    cfg = reduced(get_config("llama31_8b"))
    data_cfg = DataConfig(**dataclasses.asdict(jdata))
    jcalib = JSyntheticLM(dataclasses.replace(jdata, global_batch=4)
                          ).batch(991)
    jbatch = {"tokens": jnp.asarray(jcalib)}
    jctx = JC.build_context(jparams, jcfg, jbatch)
    tctx, tbatch = build_calibration(params, cfg, data_cfg)
    evo = train_then_sparsify.EVO
    jplan = JP.run_pipeline(jparams, jcfg, jbatch, p,
                            evo=JEvo(**dataclasses.asdict(evo)), delta=0.25,
                            coord_passes=0, ctx=jctx)
    tplan = TP.run_pipeline(params, cfg, tbatch, p, evo=evo, delta=0.25,
                            coord_passes=0, ctx=tctx)
    assert tplan.layer_ratios == jplan.layer_ratios    # no other branch
    keep = {k: 1.0 - v for k, v in jplan.layer_ratios.items()}
    assert_threshold_tie(row, jctx, tctx, jplan.alphas, tplan.alphas, keep,
                         WISPARSE_RTOL)
    want = jeval_metrics(jparams, jcfg, jdata, jplan.per_depth_sp)
    got = eval_metrics(params, cfg, data_cfg, [P.from_numpy(
        jax.tree_util.tree_map(np.asarray, s)) for s in jplan.per_depth_sp])
    assert_metrics_close(got, want)


def test_the_example_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_then_sparsify.main([])


def test_the_example_takes_steps(capsys):
    """``--steps`` below the preemption step: no restart, and 30 steps."""
    out = train_then_sparsify.main(["--steps", "30", "--device", "cpu"])
    assert len(out["losses"]) == 30
    printed = capsys.readouterr().out
    assert "simulated preemption" not in printed
    assert printed.count("WiSparse@") == 3
