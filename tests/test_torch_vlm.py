"""The port's VLM family (reduced internvl2_26b: 2 layers, d_model 64,
GQA 4/2, an 8-token patch-embedding prefix) against the JAX package:
``train`` logits with the prefix, ``prefill`` logits and caches, 8
greedy ``decode`` steps at positions past prefix and prompt under
``off``, ``mask`` and ``pallas`` (JAX's Pallas kernels interpreted, the
port's plain versions), the loss that skips the prefix
(``text_start = vision_prefix``), its every grad leaf against
``jax.value_and_grad``, and one AdamW train step.

Inputs are made from a seed with numpy; weights are JAX's init, carried
over by ``models/params.from_numpy``.  Tolerance 1e-5 in f32
(``tests/test_kernels.py``); gradients and updated params as
``tests/test_torch_train.py`` holds them."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.models import api
from repro_torch.models import model as TM
from repro_torch.models import params as P
from repro_torch.optim import adamw
from repro_torch.serving.graphs import BatchDecodeSteps
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCH = "internvl2_26b"
TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
TAUS = {"off": None, "mask": 0.05, "pallas": -np.inf}
B, S, GEN = 2, 12, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


@pytest.fixture(scope="module")
def m():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    assert jcfg.vision_prefix == cfg.vision_prefix == 8
    jparams = japi.init_model(jcfg, 0)
    rng = np.random.default_rng(7)
    patches = rng.standard_normal((B, jcfg.vision_prefix, jcfg.d_model)
                                  ).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                jsp=jdefault_sp(jparams, jcfg, keep_frac=0.5),
                params=P.from_numpy(_np(jparams)), patches=patches,
                toks=toks)


def _policies(backend):
    return (JPolicy.uniform(backend, k_max_frac=0.5, block=16,
                            interpret=True),
            SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16))


def _sps(m, backend):
    tau = TAUS[backend]
    jsp = None if tau is None else _with_tau(m["jsp"], tau)
    return jsp, None if jsp is None else P.from_numpy(_np(jsp))


@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
def test_train_logits_match_jax(m, backend):
    """Logits over prefix and tokens (B, 8 + 12, V)."""
    jpol, tpol = _policies(backend)
    jsp, sp = _sps(m, backend)
    want, _ = jax.jit(lambda p, t, pe, s: JM.forward(
        p, m["jcfg"], tokens=t, patch_embeds=pe, mode="train", sp=s,
        policy=jpol))(m["jparams"], jnp.asarray(m["toks"]),
                      jnp.asarray(m["patches"]), jsp)
    with torch.no_grad():
        got, _ = TM.forward(m["params"], m["cfg"],
                            tokens=torch.from_numpy(m["toks"]).long(),
                            patch_embeds=torch.from_numpy(m["patches"]),
                            mode="train", sp=sp, policy=tpol)
    assert tuple(got.shape) == (B, 8 + S, m["cfg"].vocab_size)
    _close(got, want)


@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
def test_prefill_caches_and_decode_match_jax(m, backend):
    """Prefill over the prefix and 12 tokens (logits, caches of 20
    positions), the caches padded to 28, then 8 greedy decode steps at
    positions 20.. (logits at each step, the caches after the last); the
    port's steps are those ``chip_smoke.generate`` drives, and it gives
    these tokens, with the eager loop and with ``BatchDecodeSteps`` (the
    step built once)."""
    jcfg, cfg = m["jcfg"], m["cfg"]
    jpol, tpol = _policies(backend)
    jsp, sp = _sps(m, backend)
    start = 8 + S
    jl, jc = jax.jit(japi.make_prefill_step(jcfg, policy=jpol))(
        m["jparams"], {"tokens": jnp.asarray(m["toks"]),
                       "patch_embeds": jnp.asarray(m["patches"])}, jsp)
    with torch.no_grad():
        tl, tc = api.make_prefill_step(cfg)(
            m["params"], torch.from_numpy(m["toks"]).long(), sp, tpol,
            patch_embeds=torch.from_numpy(m["patches"]))
    _close(tl, jl)
    for a, b in zip(jax.tree_util.tree_leaves(jc), P.tree_leaves(tc),
                    strict=True):
        assert b.shape[-1] == start or b.shape[-2] == start
        _close(b, a)
    jc = jserve._pad_caches(jcfg, jc, B, start + GEN)
    tc = api.pad_caches(cfg, tc, B, start + GEN)
    jdecode = jax.jit(japi.make_decode_step(jcfg, policy=jpol))
    decode = api.make_decode_step(cfg, tpol)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    tokens = [nxt]
    for i in range(GEN - 1):
        pos = np.full((B,), start + i, np.int32)
        jl, jc = jdecode(m["jparams"], {"tokens": jnp.asarray(nxt),
                                        "caches": jc,
                                        "positions": jnp.asarray(pos)}, jsp)
        with torch.no_grad():
            tl, tc = decode(m["params"], {
                "tokens": torch.from_numpy(nxt).long(), "caches": tc,
                "positions": torch.from_numpy(pos).long()}, sp)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tokens.append(nxt)
    for a, b in zip(jax.tree_util.tree_leaves(jc), P.tree_leaves(tc)):
        _close(b, a)
    for steps in (None, BatchDecodeSteps(cfg, m["params"], [(tpol, sp)],
                                         B, start + GEN, "cpu")):
        got = chip_smoke.generate(
            m["params"], cfg, torch.from_numpy(m["toks"]).long(), GEN,
            policy=tpol, sp=sp, patch_embeds=torch.from_numpy(m["patches"]),
            steps=steps)
        assert np.array_equal(got.numpy(), np.stack(tokens, 1))


def _batch(m):
    return {"tokens": m["toks"], "patch_embeds": m["patches"]}


def test_loss_skips_the_prefix_like_jax(m):
    """``text_start = vision_prefix``: the loss reads the logits at the
    text positions but the last, each predicting the next text token,
    and none at the prefix."""
    batch = _batch(m)
    jloss = japi.make_loss_fn(m["jcfg"])(
        m["jparams"], jax.tree_util.tree_map(jnp.asarray, batch))
    with torch.no_grad():
        loss = api.make_loss_fn(m["cfg"])(
            m["params"], {k: torch.from_numpy(v) for k, v in batch.items()})
        logits, _ = TM.forward(m["params"], m["cfg"],
                               tokens=torch.from_numpy(m["toks"]).long(),
                               patch_embeds=torch.from_numpy(m["patches"]))
        by_hand = api.token_loss(m["cfg"], logits,
                                 torch.from_numpy(m["toks"]), 8)
        # the same labels read one position earlier, from the last
        # prefix position on
        shifted = api.token_loss(m["cfg"], logits[:, 7:-1],
                                 torch.from_numpy(m["toks"]))
    assert abs(float(loss) - float(jloss)) <= TOL
    assert float(loss) == float(by_hand)
    assert abs(float(loss) - float(shifted)) > 1e-4


def test_loss_and_every_grad_leaf_match_jax(m):
    batch = _batch(m)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.make_loss_fn(m["jcfg"])))(
        m["jparams"], jax.tree_util.tree_map(jnp.asarray, batch))
    params = P.from_numpy(_np(m["jparams"]))
    leaves = P.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = api.make_loss_fn(m["cfg"])(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= TOL
    want = dict(P.tree_flatten_with_path(_np(jgrads)))
    got = P.tree_flatten_with_path(P.tree_unflatten_like(params,
                                                         list(grads)))
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_FLOOR * max(float(np.abs(w).max()), 1e-30),
            err_msg=str(path))


def test_train_step_matches_jax(m):
    """One ``make_train_step`` step (AdamW) on the batch with its patch
    embeddings: loss, grad norm and every updated param."""
    # tests/test_torch_train.py's settings and tolerance: eps 1e-3 keeps
    # the first step's g / (|g| + eps) from magnifying a grad's rounding
    ocfg = dict(lr_peak=1e-2, warmup_steps=1, decay_steps=4, eps=1e-3)
    batch = _batch(m)
    jcfg_o = jadamw.AdamWConfig(**ocfg)
    jstep = jax.jit(japi.make_train_step(m["jcfg"], jcfg_o))
    jp, _, jm = jstep(m["jparams"], jadamw.init(m["jparams"], jcfg_o),
                      jax.tree_util.tree_map(jnp.asarray, batch))
    tcfg_o = adamw.AdamWConfig(**ocfg)
    params = P.from_numpy(_np(m["jparams"]))
    tp, _, tm = api.make_train_step(m["cfg"], tcfg_o)(
        params, adamw.init(params, tcfg_o),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = dict(P.tree_flatten_with_path(_np(jp)))
    for path, t in P.tree_flatten_with_path(tp):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
