"""``repro_torch.launch.train.train()`` against the JAX package's
``train()`` from the same weights: the per-step losses, grad norms and
lrs, and the held-out loss.

The loss histories agree at 1e-4: both run the same f32 arithmetic, and
the 1e-6 per-step differences of the optimizer and the 1e-5 of the loss
(``tests/test_torch_optim.py``, ``tests/test_torch_train.py``) grow over
the steps at lr 5e-3.  The port's trainer runs on one intra-op thread
(``torch_threads``): its thousands of small CPU ops
oversubscribe the cores when the suite's workers each run threads of
their own."""
import jax
import numpy as np
import pytest

from repro.launch import train as jtrain
from repro.models import api as japi
from repro_torch.launch import train as ttrain
from repro_torch.models import params as P
from torch_threads import one_thread_module  # noqa: F401 (autouse)

HIST_TOL = 1e-4
TRAIN = dict(arch="llama31_8b", use_reduced=True, steps=20, batch=4,
             seq=64, lr=5e-3)


@pytest.mark.parametrize("kw", [{}, dict(steps=200, batch=8, seq=96)],
                         ids=["20_steps", "train_then_sparsify_recipe"])
def test_train_follows_the_jax_train(monkeypatch, kw):
    """Both trainers from the JAX package's init, over 20 steps and over
    ``examples/train_then_sparsify.py``'s 200 (without its checkpoints,
    which the runner's tests cover)."""
    run = dict(TRAIN, **kw)
    logs = []
    jparams, jcfg, _, jhist, jfinal = jtrain.train(**run, log=logs.append)
    init = japi.init_model(jcfg, 0)
    monkeypatch.setattr(
        ttrain.api, "init_model",
        lambda cfg, seed, device: P.from_numpy(
            jax.tree_util.tree_map(np.asarray, init), device))
    tlogs = []
    params, cfg, data_cfg, hist, final = ttrain.train(
        **run, log=tlogs.append, device="cpu")
    assert len(hist) == len(jhist) == run["steps"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[k] for h in hist],
                                   [h[k] for h in jhist], rtol=HIST_TOL,
                                   atol=HIST_TOL, err_msg=k)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2
    assert all(h["step_s"] > 0 for h in hist)
    assert abs(final - jfinal) < HIST_TOL
    # the same log lines, numbers aside
    assert [s.split("=")[0].split(":")[0] for s in tlogs] == \
        [s.split("=")[0].split(":")[0] for s in logs]
