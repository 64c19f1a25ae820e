"""The port's checkpoint manager and fault-tolerant runner
(``repro_torch.checkpoint``, ``repro_torch.distributed``): the
reference's seven cases of ``tests/test_checkpoint.py`` on torch trees,
checkpoints of either package restored in the other with bit-equal
leaves, and an async save unharmed by an in-place step.  ``train()``
through them: a preempted run equal to an uninterrupted one
(``tests/test_torch_train_preempted.py``) and against the JAX
``train()`` (``tests/test_torch_train_follows_jax.py``), each in a file
of its own so that the suite's workers take them in parallel."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import keystr
from repro_torch.distributed import (FailureInjector, Preemption,
                                     RunnerConfig, TrainingRunner)
from repro_torch.models import params as P
from torch_threads import one_thread_module  # noqa: F401 (autouse)

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _equal(a, b):
    for (pa, x), (pb, y) in zip(P.tree_flatten_with_path(a),
                                P.tree_flatten_with_path(b), strict=True):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa


# -- the reference's cases ---------------------------------------------------

def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = _tree()
    m.save(7, t)
    restored, meta = m.restore(t)
    assert meta["step"] == 7
    _equal(t, restored)


def test_keep_k_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        m.save(s, t)
    assert m.all_steps() == [3, 4]
    assert os.path.islink(os.path.join(str(tmp_path), "latest"))
    assert os.readlink(os.path.join(str(tmp_path), "latest")) == \
        "step_00000004"


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree()
    m.save(1, t)
    m.wait()
    assert m.latest_step() == 1


def test_restore_empty(tmp_path):
    m = CheckpointManager(str(tmp_path))
    restored, meta = m.restore(_tree())
    assert restored is None and meta is None


def _counter_runner(tmp_path, fail_at=(), total=20, every=5):
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    runner = TrainingRunner(
        RunnerConfig(total_steps=total, checkpoint_every=every),
        ckpt, injector=FailureInjector(fail_at) if fail_at else None,
        log=lambda *a: None)

    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {}

    def batch_fn(step):
        return torch.tensor(float(step))   # sum of 0..total-1 expected

    return runner.run({"x": torch.tensor(0.0)}, step_fn, batch_fn), runner


def test_runner_uninterrupted(tmp_path):
    out, _ = _counter_runner(tmp_path / "a")
    assert float(out["x"]) == sum(range(20))


def test_runner_preemption_resumes_exactly(tmp_path):
    clean, _ = _counter_runner(tmp_path / "clean")
    failed, runner = _counter_runner(tmp_path / "fail", fail_at=(7, 13))
    assert float(clean["x"]) == float(failed["x"])
    assert runner.restarts == 2


def test_runner_too_many_restarts(tmp_path):
    with pytest.raises(Preemption):
        ckpt = CheckpointManager(str(tmp_path), keep=1)
        runner = TrainingRunner(
            RunnerConfig(total_steps=5, checkpoint_every=100, max_restarts=1),
            ckpt, injector=FailureInjector((0, 1, 2)), log=lambda *a: None)
        # never checkpoints before failing -> restarts from scratch and
        # keeps hitting new injected failures past max_restarts
        runner.run({"x": torch.tensor(0.0)},
                   lambda s, b: (s, {}), lambda s: torch.tensor(0.0))


# -- the format across both packages -----------------------------------------

def _state_pair(seed=0):
    """One train-state-shaped tree, as numpy, with an f32, an int32
    scalar, a nested list and a tuple at the root (the runner's
    ``(params, opt_state)``)."""
    rng = np.random.default_rng(seed)
    params = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "groups": [{"l0": {"attn": {"wq": rng.standard_normal(
                  (2, 4, 4)).astype(np.float32)}}}]}
    opt = {"m": {"w": rng.standard_normal(3).astype(np.float32)},
           "step": np.array(17, np.int32)}
    return params, opt


def test_keystr_matches_jax():
    params, opt = _state_pair()
    tree = (params, opt)
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [keystr(p) for p, _ in P.tree_flatten_with_path(tree)] == want
    assert "[0]['groups'][0]['l0']['attn']['wq']" in want


def test_jax_checkpoint_restores_in_the_port_bit_equal(tmp_path):
    params, opt = _state_pair(1)
    bf = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    jtree = (jax.tree_util.tree_map(jnp.asarray, params),
             {**jax.tree_util.tree_map(jnp.asarray, opt),
              "bf": jnp.asarray(bf, dtype=jnp.bfloat16)})
    JManager(str(tmp_path)).save(5, jtree, {"arch": "x"})
    template = (P.from_numpy(params),
                {**P.from_numpy(opt),
                 "bf": torch.zeros(3, 5, dtype=torch.bfloat16)})
    restored, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 5 and meta["arch"] == "x"
    for (path, got), (_, want) in zip(
            P.tree_flatten_with_path(restored),
            P.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray,
                                                            jtree))):
        if got.dtype == torch.bfloat16:
            # bit-equal: the raw bf16 bits of the JAX leaf
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16)), path
        else:
            assert got.numpy().dtype == want.dtype, path
            assert np.array_equal(got.numpy(), want), path


def test_port_checkpoint_restores_in_jax_bit_equal(tmp_path):
    params, opt = _state_pair(3)
    tree = (P.from_numpy(params), P.from_numpy(opt))
    CheckpointManager(str(tmp_path)).save(9, tree)
    jtemplate = jax.tree_util.tree_map(jnp.asarray, (params, opt))
    restored, meta = JManager(str(tmp_path)).restore(jtemplate)
    assert meta["step"] == 9
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    P.tree_leaves(tree), strict=True):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


def test_bf16_leaves_are_raw_bits_the_reference_cannot_read(tmp_path):
    """The port writes a bf16 leaf as the reference does (``|V2``, the
    raw bits) and reads it back bit-equal; the reference's own restore
    cannot cast ``V2`` to bfloat16, for its checkpoints and the port's
    alike (a mirrored behaviour)."""
    t = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    CheckpointManager(str(tmp_path)).save(1, t)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["['w']"].dtype == np.dtype("V2")
    restored, _ = CheckpointManager(str(tmp_path)).restore(t)
    _equal(t, restored)
    with pytest.raises(ValueError):
        JManager(str(tmp_path)).restore(
            {"w": jnp.zeros((4, 4), jnp.bfloat16)})


def test_async_snapshot_is_unharmed_by_an_in_place_step(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)
    t = {"w": torch.randn(256, 256), "bf": torch.randn(8).to(torch.bfloat16)}
    want = {k: v.clone() for k, v in t.items()}
    m.save(1, t)
    t["w"].add_(1.0)                         # the next optimizer step
    t["bf"].mul_(2.0)
    m.wait()
    restored, _ = m.restore(want)
    _equal(want, restored)
