"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's, on the same numpy inputs.

Tolerance 1e-6 (absolute and relative) throughout: both run the same f32
operations in the same order, so they differ at most by the last bit of
a transcendental (``cos``, ``pow``, ``sqrt``) carried through three
steps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import adamw as jadamw
from repro_torch.models import params as P
from repro_torch.optim import adamw
from torch_threads import one_thread_module  # noqa: F401 (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)
CFG = dict(lr_peak=1e-2, warmup_steps=2, decay_steps=6, lr_min=1e-3)


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": a(8, 5), "blocks": [{"a": a(3), "b": a(2, 2)},
                                     {"a": a(3), "b": a(2, 2)}],
            "z": a(4, 1, 3)}


def _close(got, want):
    for (path, g), (_, w) in zip(P.tree_flatten_with_path(got),
                                 P.tree_flatten_with_path(want),
                                 strict=True):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("warmup,decay", [(100, 10_000), (5, 20), (0, 1),
                                          (3, 3)])
def test_schedule_matches_jax(warmup, decay):
    cfg = dict(lr_peak=3e-3, warmup_steps=warmup, decay_steps=decay,
               lr_min=1e-4)
    steps = np.arange(0, max(decay, warmup) + 5, dtype=np.int32)
    got = adamw.schedule(adamw.AdamWConfig(**cfg), torch.from_numpy(steps))
    want = jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_copies_and_matches_jax():
    tree = _np_tree(0)
    params = P.from_numpy(tree)
    params["bf"] = torch.ones(3, dtype=torch.bfloat16)
    cfg = adamw.AdamWConfig(compress_grads=True)
    st_ = adamw.init(params, cfg)
    assert set(st_) == {"m", "v", "master", "step", "ef"}
    assert st_["step"].dtype == torch.int32 and int(st_["step"]) == 0
    for p, m in zip(P.tree_leaves(params), P.tree_leaves(st_["master"])):
        assert m.dtype == torch.float32
        assert m.data_ptr() != p.data_ptr()          # no aliasing
        assert torch.equal(m, p.float())
    for k in ("m", "v", "ef"):
        assert all(not t.any() and t.dtype == torch.float32
                   for t in P.tree_leaves(st_[k]))
    jst = jadamw.init(tree, jadamw.AdamWConfig(compress_grads=True))
    assert set(jst) == set(st_)
    params["w"].add_(1.0)                  # a write to params ...
    assert not torch.equal(st_["master"]["w"], params["w"])  # ... stays


def test_global_norm_matches_jax():
    tree = _np_tree(1, scale=3.0)
    got = adamw.global_norm(P.from_numpy(tree))
    want = jadamw.global_norm(tree)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@given(st.integers(0, 2**16), st.integers(1, 64), st.floats(1e-3, 1e3))
@settings(max_examples=60, deadline=None)
def test_quantize_int8_matches_jax_and_feeds_back(seed, n, scale):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n,)) * scale).astype(np.float32)
    ef = np.zeros_like(g)
    jef = jnp.asarray(ef)
    tot = np.zeros_like(g)
    for _ in range(8):
        deq, ef_t = adamw._quantize_int8(torch.from_numpy(g),
                                         torch.from_numpy(ef))
        jdeq, jef = jadamw._quantize_int8(jnp.asarray(g), jef)
        np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq),
                                   rtol=1e-6, atol=1e-6 * scale)
        np.testing.assert_allclose(ef_t.numpy(), np.asarray(jef),
                                   rtol=1e-6, atol=1e-6 * scale)
        ef = ef_t.numpy()
        tot += deq.numpy()
    # the error-feedback invariant: the dequantized sum trails the true
    # sum by exactly the carried residual
    np.testing.assert_allclose(tot + ef, 8 * g, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("compress", [False, True])
def test_three_updates_match_jax(compress):
    params_np = _np_tree(2)
    cfg = adamw.AdamWConfig(**CFG, compress_grads=compress)
    jcfg = jadamw.AdamWConfig(**CFG, compress_grads=compress)
    params = P.from_numpy(params_np)
    state = adamw.init(params, cfg)
    jparams = P.tree_map(jnp.asarray, params_np)
    jstate = jadamw.init(jparams, jcfg)
    for i in range(3):
        grads_np = _np_tree(10 + i, scale=0.5 + i)   # clips on step 3
        params, state, met = adamw.update(P.from_numpy(grads_np), state,
                                          params, cfg)
        jparams, jstate, jmet = jadamw.update(
            P.tree_map(jnp.asarray, grads_np), jstate, jparams, jcfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL)
        _close(params, jparams)
        for k in ("m", "v", "master") + (("ef",) if compress else ()):
            _close(state[k], jstate[k])
        assert int(state["step"]) == int(jstate["step"]) == i + 1
    # params were written in place and still do not alias master
    for p, m in zip(P.tree_leaves(params), P.tree_leaves(state["master"])):
        assert p.data_ptr() != m.data_ptr() and torch.equal(p, m)


def test_bf16_params_take_the_cast_master():
    params = {"w": torch.from_numpy(_np_tree(3)["w"]).to(torch.bfloat16)}
    cfg = adamw.AdamWConfig(**CFG)
    state = adamw.init(params, cfg)
    jparams = {"w": jnp.asarray(params["w"].float().numpy(),
                                dtype=jnp.bfloat16)}
    jstate = jadamw.init(jparams, jadamw.AdamWConfig(**CFG))
    g = _np_tree(4)["w"]
    params, state, _ = adamw.update(
        {"w": torch.from_numpy(g).to(torch.bfloat16)}, state, params, cfg)
    jparams, jstate, _ = jadamw.update(
        {"w": jnp.asarray(g, dtype=jnp.bfloat16)}, jstate, jparams,
        jadamw.AdamWConfig(**CFG))
    assert params["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(state["master"]["w"].numpy(),
                               np.asarray(jstate["master"]["w"]), **TOL)
    assert torch.equal(params["w"], state["master"]["w"].to(torch.bfloat16))
