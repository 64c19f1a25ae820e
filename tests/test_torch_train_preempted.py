"""``repro_torch.launch.train.train()`` preempted and resumed from its
checkpoints against the same run uninterrupted, bit for bit.

The trainer runs on one intra-op thread (``torch_threads``): its
thousands of small CPU ops oversubscribe the cores when the suite's
workers each run threads of their own."""
import os

import torch

from repro_torch.launch import train as ttrain
from repro_torch.models import params as P
from torch_threads import one_thread_module  # noqa: F401 (autouse)

TRAIN = dict(arch="llama31_8b", use_reduced=True, steps=24, batch=8,
             seq=96, lr=5e-3)


def _equal(a, b):
    for (pa, x), (pb, y) in zip(P.tree_flatten_with_path(a),
                                P.tree_flatten_with_path(b), strict=True):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa


def test_preempted_train_equals_uninterrupted_bit_for_bit(tmp_path):
    """At the example's batch 8 x 96, where the CPU's threaded index
    accumulation (the embedding and gather backwards) makes two plain
    runs differ, ``train()``'s deterministic kernels keep them equal."""
    quiet = dict(TRAIN, log=lambda *a: None, device="cpu", ckpt_every=5)
    p0, _, _, h0, f0 = ttrain.train(**quiet, ckpt_dir=str(tmp_path / "a"))
    p1, _, _, h1, f1 = ttrain.train(**quiet, ckpt_dir=str(tmp_path / "b"),
                                    fail_at=(7, 21))
    assert len(h1) == len(h0) + 2 + 1    # steps 5-6 and 20 run twice
    _equal(p0, p1)
    assert f0 == f1
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
