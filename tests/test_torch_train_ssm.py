"""The port's loss and gradients on the SSM archs (reduced mamba2_130m
and the jamba hybrid) against the JAX package's, with the checks and
tolerances of ``tests/test_torch_train.py`` (split out to keep each
file near a minute on one worker; jamba's JAX gradient takes most of
it to compile).  Remat on a hybrid stack: ``full`` and ``dots`` give the
grads of ``none`` bit for bit."""
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.models import params as P
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "train_checks",
    pathlib.Path(__file__).resolve().parent / "test_torch_train.py")
train_checks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(train_checks)


@pytest.mark.parametrize("arch", ["mamba2_130m", "jamba_v01_52b"])
def test_loss_and_every_grad_leaf_match_jax(arch):
    train_checks.check_loss_and_grads(arch)


def test_remat_policies_give_equal_grads_on_jamba():
    m = train_checks._model("jamba_v01_52b")
    loss, grads = train_checks._grads(m["cfg"], m["params"], m["toks"])
    for remat in ("dots", "full"):
        l2, g2 = train_checks._grads(m["cfg"], m["params"], m["toks"],
                                     remat=remat)
        assert l2 == loss
        for (path, a), (_, b) in zip(P.tree_flatten_with_path(grads),
                                     P.tree_flatten_with_path(g2)):
            assert torch.equal(a, b), (remat, path)
