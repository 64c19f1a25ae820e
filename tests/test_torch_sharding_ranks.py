"""The port's steps on a real multi-rank mesh against the unsharded JAX
functions: one ``gloo`` group of four CPU processes per mesh, a 2x2
("data", "model") mesh and a 1x4 one, where ``kv_heads`` = 2 cannot
shard over model = 4 and replicates while the caches' time axis takes
the model axis instead (flash-decoding across ranks).

GSPMD keeps the unsharded result, and the reference's own mesh path
refuses this JAX's Explicit mesh axes, so the unsharded JAX function,
called outside any context, is the reference.  On reduced llama31_8b,
granite_moe_3b_a800m and mamba2_130m in f32 (``allclose`` rtol = atol =
1e-5): the train loss and every grad leaf under ``LOGICAL_RULES_TRAIN``;
prefill logits and three greedy decode steps (two ``aligned``, one
per-row write) under ``LOGICAL_RULES_SERVE``, their tokens exactly
equal; one AdamW step on sharded state, both fed the same seeded grads,
at 1e-6.  The row-parallel grouped top-k on a model-sharded weight equals
the unsharded grouped call.  The ranks run ``tests/torch_sharding_worker.py``
(torch only); both meshes' groups start together and the JAX references
are computed here while they run."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharding_worker
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.serve import _pad_caches as jpad_caches
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.models import params as P
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ARCHS = torch_sharding_worker.ARCHS
B, S, STEPS = 4, 16, 3
CACHE_LEN = 24          # divisible by model = 4: the 1x4 mesh shards time
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                  if a.dtype != np.int32 else np.asarray(a),
                                  tree)


def _reference(arch, inp):
    jcfg = jreduced(jget_config(arch))
    jparams = jax.tree_util.tree_map(jnp.asarray, P.to_numpy(inp["params"]))
    toks = inp["tokens"].numpy().astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(japi.make_loss_fn(jcfg)))(
        jparams, {"tokens": jnp.asarray(toks)})
    ocfg = jadamw.AdamWConfig()
    jgrads = P.tree_unflatten_like(jparams, [jnp.asarray(g.numpy())
                                             for g in inp["grads"]])
    new_params, _, _ = jax.jit(
        lambda g, p: jadamw.update(g, jadamw.init(p, ocfg), p, ocfg))(
            jgrads, jparams)
    logits, caches = jax.jit(japi.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    caches = jpad_caches(jcfg, caches, B, CACHE_LEN)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    dec, toks_out = [], []
    for i in range(STEPS):
        step = jax.jit(japi.make_decode_step(jcfg, aligned=i < STEPS - 1))
        lg, caches = step(jparams, {
            "tokens": tok, "positions": jnp.full((B,), S + i, jnp.int32),
            "caches": caches})
        dec.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks_out.append(np.asarray(tok))
    return {
        "loss": float(loss),
        "grads": [np.asarray(g) for g in P.tree_leaves(_np(grads))],
        "adamw": [np.asarray(p) for p in P.tree_leaves(_np(new_params))],
        "prefill": np.asarray(logits), "decode": dec, "tokens": toks_out,
    }


MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' groups, started at once, and the JAX references
    computed while they run.  Yields (refs, {mesh: (context, dir)})."""
    inputs = {arch: torch_sharding_worker.seeded_inputs(
        arch, B, S, CACHE_LEN, STEPS) for arch in ARCHS}
    started = {}
    for name, shape in MESHES.items():
        work = tmp_path_factory.mktemp(f"mesh{name}")
        torch.save(inputs, work / "inputs.pt")
        world = shape[0] * shape[1]
        ctx = mp.start_processes(
            torch_sharding_worker.worker,
            args=(world, str(work / "init"), shape, str(work)),
            nprocs=world, join=False, start_method="spawn")
        started[name] = (ctx, work)
    refs = {arch: _reference(arch, inputs[arch]) for arch in ARCHS}
    yield refs, started
    for ctx, _ in started.values():
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_steps_match_unsharded_jax(mesh, runs):
    refs, started = runs
    ctx, work = started[mesh]
    while not ctx.join():
        pass
    outs = torch.load(work / "out.pt")
    for arch in ARCHS:
        ref, out = refs[arch], outs[arch]
        _close(out["loss"], ref["loss"], what=f"{arch} loss")
        for i, (g, want) in enumerate(zip(out["grads"], ref["grads"],
                                          strict=True)):
            _close(g.numpy(), want, what=f"{arch} grad leaf {i}")
        for i, (p, want) in enumerate(zip(out["adamw"], ref["adamw"],
                                          strict=True)):
            _close(p.numpy(), want, 1e-6, what=f"{arch} adamw leaf {i}")
        _close(out["prefill"].numpy(), ref["prefill"], what=f"{arch} prefill")
        for i in range(STEPS):
            _close(out["decode"][i].numpy(), ref["decode"][i],
                   what=f"{arch} decode step {i}")
            np.testing.assert_array_equal(out["tokens"][i].numpy(),
                                          ref["tokens"][i])
    _close(outs["llama31_8b"]["grouped"].numpy(),
           outs["llama31_8b"]["grouped_ref"].numpy(), what="grouped top-k")


def test_worker_imports_no_jax():
    """The ranks never load JAX: the worker module imports torch only."""
    src = open(os.path.join(os.path.dirname(__file__),
                            "torch_sharding_worker.py")).read()
    assert "import jax" not in src and "from repro." not in src
