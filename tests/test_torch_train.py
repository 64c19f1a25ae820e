"""The port's loss, gradients and train step (``models/api.py``
``token_loss`` / ``make_loss_fn`` / ``make_train_step``, remat, the bf16
head's backward) against the JAX package's, on JAX-initialised weights
carried over by ``models/params.from_numpy``.

Reduced configs are f32 on the CPU.  Tolerances: the loss at 1e-5 (as
the logits of ``tests/test_torch_model.py``, plus one f32 mean); each
gradient leaf at rtol 1e-4 with an absolute floor of 1e-5 of the leaf's
largest |grad|: a gradient is the logits' error carried back through
every layer once more, and the floor covers entries that are sums of
terms cancelling to near zero.  The JAX side is jitted (one trace)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.models import api
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.optim import adamw
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

# mamba2_130m and jamba_v01_52b: tests/test_torch_train_ssm.py
ARCHS = ["llama31_8b", "gemma2_2b", "granite_moe_1b_a400m"]
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
B, S = 2, 48            # past the reduced gemma2 window (32), 3 SSD chunks


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _set_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _set_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_set_tau(v, value) for v in tree]
    return tree


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jreduced(jget_config(arch))
        jparams = japi.init_model(jcfg, 0)
        toks = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        _MODELS[arch] = dict(jcfg=jcfg, cfg=reduced(get_config(arch)),
                             jparams=jparams, toks=toks)
    m = _MODELS[arch]
    return dict(m, params=P.from_numpy(_np(m["jparams"])))


def _grads(cfg, params, toks, sp=None, policy=None, remat="none"):
    loss_fn = api.make_loss_fn(cfg, remat, policy=policy)
    leaves = P.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(params, {"tokens": torch.from_numpy(toks)}, sp)
    grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return loss.item(), P.tree_unflatten_like(params, list(grads))


def _jgrads(m, jsp=None, jpolicy=None):
    fn = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(m["jcfg"], policy=jpolicy)))
    loss, g = fn(m["jparams"], {"tokens": jnp.asarray(m["toks"])}, jsp)
    return float(loss), g


def _check_grads(got, want):
    want = dict(P.tree_flatten_with_path(_np(want)))
    got = P.tree_flatten_with_path(got)
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_FLOOR * max(float(np.abs(w).max()), 1e-30),
            err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax(arch):
    check_loss_and_grads(arch)


def check_loss_and_grads(arch):
    m = _model(arch)
    loss, grads = _grads(m["cfg"], m["params"], m["toks"])
    jloss, jgrads = _jgrads(m)
    assert abs(loss - jloss) <= LOSS_TOL, (loss, jloss)
    assert abs(loss - np.log(m["cfg"].vocab_size)) < 1.0    # near uniform
    _check_grads(grads, jgrads)


def test_token_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    toks = rng.integers(0, 11, (3, 7)).astype(np.int32)
    cfg = reduced(get_config("llama31_8b"))
    jcfg = jreduced(jget_config("llama31_8b"))
    for start in (0, 2):
        got = api.token_loss(cfg, torch.from_numpy(logits),
                             torch.from_numpy(toks)[:, start:], start)
        want = japi.token_loss(jcfg, jnp.asarray(logits),
                               jnp.asarray(toks)[:, start:], start)
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_mask_with_a_finite_tau_matches_jax():
    """``mask`` under a calibrated-looking sp tree (alpha 1, a finite tau
    per layer): grads flow through ``x * m`` only, in both packages."""
    m = _model("llama31_8b")
    jsp = _set_tau(jdefault_sp(m["jparams"], m["jcfg"], keep_frac=0.5), 0.02)
    sp = P.from_numpy(_np(jsp))
    loss, grads = _grads(m["cfg"], m["params"], m["toks"], sp,
                         SparsityPolicy.uniform("mask"))
    jloss, jgrads = _jgrads(m, jsp, JPolicy.uniform("mask"))
    assert abs(loss - jloss) <= LOSS_TOL
    dense, _ = _grads(m["cfg"], m["params"], m["toks"])
    assert abs(loss - dense) > 1e-4              # the mask really drops
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("arch", ["llama31_8b", "granite_moe_1b_a400m"])
def test_remat_policies_give_equal_grads(arch):
    m = _model(arch)
    loss, grads = _grads(m["cfg"], m["params"], m["toks"])
    for remat in ("dots", "full"):
        l2, g2 = _grads(m["cfg"], m["params"], m["toks"], remat=remat)
        assert l2 == loss
        for (path, a), (_, b) in zip(P.tree_flatten_with_path(grads),
                                     P.tree_flatten_with_path(g2)):
            assert torch.equal(a, b), (remat, path)


def test_remat_policies_recompute_what_they_should():
    """The backward's ops: ``none`` recomputes nothing; ``dots`` keeps the
    projections' products (no ``mm`` more than ``none``) and recomputes
    the rest of each layer body; ``full`` recomputes the products too."""
    m = _model("llama31_8b")
    counts = {}
    for remat in ("none", "dots", "full"):
        fn = api.make_loss_fn(m["cfg"], remat)
        leaves = P.tree_leaves(m["params"])
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = fn(m["params"], {"tokens": torch.from_numpy(m["toks"])})
        with _OpCounter() as ops:
            torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        counts[remat] = (ops.mm, ops.total)
    (mm_n, all_n), (mm_d, all_d), (mm_f, all_f) = (
        counts["none"], counts["dots"], counts["full"])
    assert mm_n == mm_d < mm_f, counts
    assert all_n < all_d < all_f, counts


def _head_grads(x, w, g, cotangent_dtype=None):
    """Grads of ``sum(g * (x @ w))`` in f32 (``cotangent_dtype`` rounds
    ``g`` first), each cast to its operand's dtype as the reference's
    transposed f32-output product does."""
    if cotangent_dtype is not None:
        g = g.to(cotangent_dtype).float()
    return ((g @ w.float().T).to(x.dtype), (x.float().T @ g).to(w.dtype))


def test_head_product_multiplies_the_f32_cotangent(monkeypatch):
    """The bf16 head's backward (``model._HeadProduct``, the card's path
    for bf16 logits) against the f32 cotangent times the operands: each
    grad within 1e-4 of its norm, where rounding the cotangent to bf16
    misses by more.  Chunks of 100 vocab columns over 250 exercise a
    ragged last chunk; the cotangent spans 2^-20..2^20."""
    monkeypatch.setattr(M, "HEAD_CHUNK", 100)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 48))).bfloat16()
    w = torch.from_numpy(rng.standard_normal((48, 250))).bfloat16()
    g = torch.from_numpy(rng.standard_normal((64, 250)) * 2.0 ** rng.uniform(
        -20, 20, (64, 250))).float()
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = M._HeadProduct.apply(xg, wg)
    torch.testing.assert_close(y, x.float() @ w.float(), rtol=1e-6, atol=0)
    got = torch.autograd.grad(y, (xg, wg), g)
    for a, want, cast in zip(got, _head_grads(x, w, g),
                             _head_grads(x, w, g, torch.bfloat16)):
        assert a.dtype == torch.bfloat16
        norm = float(want.float().norm())
        assert float((a.float() - want.float()).norm()) <= 1e-4 * norm
        assert float((cast.float() - want.float()).norm()) > 1e-4 * norm


def test_stacked_params_take_their_grads_in_one_stack():
    """A stacked group's reps are split by one ``unbind`` per leaf, so the
    backward stacks each leaf's rep grads once; indexing a rep per layer
    would add a zero-filled grad of the whole stack per rep."""
    m = _model("llama31_8b")
    assert m["cfg"].layer_groups()[0][1] == 2             # two reps
    leaves = P.tree_leaves(m["params"])
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = api.make_loss_fn(m["cfg"])(
        m["params"], {"tokens": torch.from_numpy(m["toks"])})
    with _OpCounter() as ops:
        torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    stacked = {tuple(t.shape) for t in P.tree_leaves(m["params"]["groups"])}
    assert not stacked & set(ops.selected), ops.selected
    assert ops.names.get("aten.stack.default", 0) > 0


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.total = 0
        self.names = {}
        self.selected = []          # the full shapes select_backward fills

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.total += 1
        self.names[str(func)] = self.names.get(str(func), 0) + 1
        if func is torch.ops.aten.select_backward.default:
            self.selected.append(tuple(args[1]))
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_with_accumulation_matches_jax(accum):
    """One ``make_train_step`` step (loss, grad norm, lr and every updated
    param) against the reference's, at ``accum_steps`` 1 and 2."""
    m = _model("llama31_8b")
    # eps 1e-3 in place of 1e-8: the first step's update is g / (|g| +
    # eps), whose slope 1/eps would turn a grad's f32 rounding near 0
    # into a step of up to lr; at 1e-3 a param's error stays under lr *
    # GRAD_FLOOR * max|g| / eps
    ocfg = dict(lr_peak=1e-2, warmup_steps=1, decay_steps=4, eps=1e-3)
    step = api.make_train_step(m["cfg"], adamw.AdamWConfig(**ocfg),
                               accum_steps=accum)
    params = m["params"]
    opt = adamw.init(params, adamw.AdamWConfig(**ocfg))
    params, opt, met = step(params, opt,
                            {"tokens": torch.from_numpy(m["toks"])})
    jstep = jax.jit(japi.make_train_step(
        m["jcfg"], jadamw.AdamWConfig(**ocfg), accum_steps=accum))
    jopt = jadamw.init(m["jparams"], jadamw.AdamWConfig(**ocfg))
    jparams, jopt, jmet = jstep(m["jparams"], jopt,
                                {"tokens": jnp.asarray(m["toks"])})
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=GRAD_RTOL)
    assert float(met["lr"]) == float(jmet["lr"])
    want = dict(P.tree_flatten_with_path(_np(jparams)))
    for path, p in P.tree_flatten_with_path(params):
        np.testing.assert_allclose(p.numpy(), want[path], rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
    assert int(opt["step"]) == 1


def test_pallas_under_an_sp_tree_has_no_backward():
    """The reference raises ``NotImplementedError`` when a ``pallas``
    projection is differentiated; so does the port, in the loss's
    backward and in the train step.  Without an sp tree, ``pallas`` runs
    dense and trains."""
    m = _model("llama31_8b")
    jsp = _set_tau(jdefault_sp(m["jparams"], m["jcfg"], keep_frac=0.5),
                   float("-inf"))
    sp = P.from_numpy(_np(jsp))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    with pytest.raises(NotImplementedError, match="no backward"):
        _grads(m["cfg"], m["params"], m["toks"], sp, pol)
    step = api.make_train_step(m["cfg"], adamw.AdamWConfig(), policy=pol)
    params = m["params"]
    opt = adamw.init(params, adamw.AdamWConfig())
    batch = {"tokens": torch.from_numpy(m["toks"])}
    with pytest.raises(NotImplementedError):
        step(params, opt, batch, sp)
    assert not any(t.requires_grad for t in P.tree_leaves(params))
    _, _, met = step(params, opt, batch)          # no sp tree: dense
    assert np.isfinite(float(met["loss"]))
    # forward alone (no grad) still serves pallas
    with torch.no_grad():
        api.make_loss_fn(m["cfg"], policy=pol)(params, batch, sp)
    jfn = jax.value_and_grad(japi.make_loss_fn(m["jcfg"], policy=JPolicy.uniform(
        "pallas", k_max_frac=0.5, block=16, interpret=True)))
    with pytest.raises(NotImplementedError):
        jfn(m["jparams"], {"tokens": jnp.asarray(m["toks"])}, jsp)


@pytest.mark.parametrize("arch", ["internvl2_26b", "whisper_large_v3"])
def test_vlm_and_encdec_losses_raise(arch):
    """The VLM and enc-dec losses and train steps read the family's
    second input from the batch: on tokens alone they raise the
    reference's ``KeyError`` (their parity with it on full batches:
    ``tests/test_torch_vlm.py``, ``tests/test_torch_whisper.py``)."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    key = "patch_embeds" if cfg.family == "vlm" else "frames"
    toks = np.zeros((1, 4), np.int32)
    jparams = japi.init_model(jcfg, 0)
    params = P.from_numpy(_np(jparams))
    with pytest.raises(KeyError) as jexc:
        japi.make_loss_fn(jcfg)(jparams, {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError) as texc:
        api.make_loss_fn(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert texc.value.args == jexc.value.args == (key,)
    step = api.make_train_step(cfg, adamw.AdamWConfig())
    with pytest.raises(KeyError, match=key):
        step(params, adamw.init(params, adamw.AdamWConfig()),
             {"tokens": torch.from_numpy(toks)})
