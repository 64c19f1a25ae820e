"""The port's model layers, params, policy and forward against the JAX
package, on the same numpy inputs and JAX-initialised weights.

Reduced llama31_8b is f32 on the CPU.  Tolerances: 1e-5 for single
layers (f32 rounding), 1e-4 for logits (f32 sums taken in another order
over 2 layers).  Sparse backends run with ``policy.block=16`` so each
projection has at least 4 channel blocks to choose from."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.models import api, attention, layers
from repro_torch.models import model as TM
from repro_torch.models import params as P
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

BACKENDS = ["off", "mask", "topk_shared", "topk_block", "pallas"]
LOGIT_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _set_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _set_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_set_tau(v, value) for v in tree]
    return tree


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    cfg = reduced(get_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    # a calibrated-looking sp tree: alpha 1, keep 0.5, and a finite tau
    # per layer so the mask backend thresholds for real
    jsp = _set_tau(jdefault_sp(jparams, jcfg, keep_frac=0.5), 0.02)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jsp=jsp,
                params=P.from_numpy(_np(jparams)),
                sp=P.from_numpy(_np(jsp)))


def _policies(backend):
    kw = dict(k_max_frac=0.5, block=16)
    return (JPolicy.uniform(backend, interpret=True, **kw),
            SparsityPolicy.uniform(backend, **kw))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_configs_are_field_equal():
    for name in ("llama31_8b", "gemma_2b", "mamba2_130m"):
        a, b = jget_config(name), get_config(name)
        assert a.__dict__ == b.__dict__
        assert jreduced(a).__dict__ == reduced(b).__dict__
        assert a.layer_groups() == b.layer_groups()


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    want = np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    got = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = np.array([[0, 3, 17, 511]], np.int32)
    x = rng.standard_normal((1, 4, 2, 16)).astype(np.float32)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 16, 500000.0)
    tc, ts = layers.rope_angles(torch.from_numpy(pos), 16, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js))
    got = layers.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _qkv(B, S, T, H=4, KV=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, KV, hd, T)).astype(np.float32)
    vc = rng.standard_normal((B, KV, T, hd)).astype(np.float32)
    return q, kc, vc


def test_decode_attention_matches_jax():
    q, kc, vc = _qkv(3, 1, 12)
    rng = np.random.default_rng(2)
    kn = rng.standard_normal((3, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((3, 2, 16)).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    want = jattn.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(pos),
                                  jnp.asarray(kn), jnp.asarray(vn))
    got = attention.decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos), torch.from_numpy(kn), torch.from_numpy(vn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cache_write_kv_matches_jax():
    _, kc, vc = _qkv(3, 1, 12)
    rng = np.random.default_rng(3)
    kn = rng.standard_normal((3, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((3, 2, 16)).astype(np.float32)
    pos = np.array([4, 0, 11], np.int32)
    jk, jv = jattn.cache_write_kv(jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(pos))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    attention.cache_write_kv(tk, tv, torch.from_numpy(kn),
                             torch.from_numpy(vn), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("offset", [0, 5, 12])
def test_chunk_attention_matches_jax(offset):
    q, kc, vc = _qkv(2, 4, 16, seed=4)
    want = jattn.chunk_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.int32(offset))
    got = attention.chunk_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S", [1, 9])
def test_flash_attention_matches_jax(S):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True)
    got = attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rounding_is_half_to_even_as_in_jax():
    """keep_frac * n and k_frac * nb land on .5 for some budgets; the
    port rounds them the reference's way (Python round, torch.round and
    jnp.round all round half to even)."""
    halves = np.array([0.5, 1.5, 2.5, 3.5, 24.5], np.float32)
    want = np.asarray(jnp.round(jnp.asarray(halves)))
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves)).numpy(),
                                  want)
    assert [round(float(h)) for h in halves] == want.astype(int).tolist()


# ---------------------------------------------------------------------------
# params, sp trees, policy
# ---------------------------------------------------------------------------

def test_from_numpy_round_trips_a_jax_model(model):
    want = _np(model["jparams"])
    got = P.to_numpy(model["params"])
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    bf = P.from_numpy(want, dtype="bfloat16")
    assert bf["groups"][0]["l0"]["attn"]["wq"].dtype == torch.bfloat16


def test_init_model_matches_jax_schema_and_is_deterministic(model):
    a = api.init_model(model["cfg"], 0, device="cpu")
    b = api.init_model(model["cfg"], 0, device="cpu")
    c = api.init_model(model["cfg"], 1, device="cpu")
    ref = _np(model["jparams"])
    for (pa, ta), (_, tb), (_, tc), (pr, r) in zip(
            jax.tree_util.tree_leaves_with_path(P.to_numpy(a)),
            jax.tree_util.tree_leaves_with_path(P.to_numpy(b)),
            jax.tree_util.tree_leaves_with_path(P.to_numpy(c)),
            jax.tree_util.tree_leaves_with_path(ref)):
        assert pa == pr and ta.shape == r.shape and ta.dtype == r.dtype
        np.testing.assert_array_equal(ta, tb)
        if np.any(r):                   # normal-init leaves
            assert np.abs(ta).max() <= 2 * 0.02 + 1e-6
            assert not np.array_equal(ta, tc)
        else:                           # zeros-init norms
            assert not np.any(ta)


def test_init_model_needs_a_card_unless_asked_for_cpu(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_model(model["cfg"], 0)


@pytest.mark.parametrize("keep,tau", [(0.5, float("inf")),
                                      (0.25, float("-inf"))])
def test_default_sp_stacked_matches_jax(model, keep, tau):
    want = _set_tau(jdefault_sp(model["jparams"], model["jcfg"],
                                keep_frac=keep), tau)
    got = default_sp_stacked(model["params"], model["cfg"], keep_frac=keep,
                             tau=tau)
    fw = jax.tree_util.tree_leaves_with_path(_np(want))
    fg = jax.tree_util.tree_leaves_with_path(P.to_numpy(got))
    assert [p for p, _ in fw] == [p for p, _ in fg]
    for (_, a), (_, b) in zip(fw, fg):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    # the reference's default keeps tau=+inf
    d = default_sp_stacked(model["params"], model["cfg"])
    assert torch.isinf(d[0]["l0"]["attn"]["wq"]["tau"]).all()


def test_policy_round_trips_through_the_jax_dict():
    jp = JPolicy.uniform("pallas", k_max_frac=0.5, block=16,
                         role_backends=(("wo", "mask"),),
                         block_backends=((0, 1, "off"),))
    tp = SparsityPolicy.from_dict(jp.to_dict())
    assert tp.to_dict() == jp.to_dict()
    assert JPolicy.from_dict(tp.to_dict()) == jp
    for depth in (0, 1, None):
        for role in ("attn/wo", "mlp/wo", "attn/wq", None):
            assert tp.backend_at(depth, role) == jp.backend_at(depth, role)
        if depth is not None:
            assert tp.resolve_depth(depth).backend == \
                jp.resolve_depth(depth).backend
    for phase in ("prefill_dense", "prefill_sparse", "decode"):
        assert tp.for_phase(phase).to_dict() == jp.for_phase(phase).to_dict()
    assert tp.is_dense == jp.is_dense
    assert tp.prefix_deterministic() == jp.prefix_deterministic()
    with pytest.raises(ValueError, match="valid backends"):
        SparsityPolicy.uniform("bogus")


# ---------------------------------------------------------------------------
# logits of reduced llama31_8b, every mode x backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_logits_match_jax(model, backend):
    jpol, tpol = _policies(backend)
    toks = np.random.default_rng(6).integers(0, 256, (2, 12))
    jl, jc = JM.forward(model["jparams"], model["jcfg"],
                        tokens=jnp.asarray(toks), mode="prefill",
                        sp=model["jsp"], policy=jpol)
    tl, tc = TM.forward(model["params"], model["cfg"],
                        tokens=torch.from_numpy(toks), mode="prefill",
                        sp=model["sp"], policy=tpol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc[0][0]["self"]["k"].numpy(),
                               np.asarray(jc[0][0]["self"]["k"]), atol=1e-5)


def _pool(model, slots, T, seed):
    rng = np.random.default_rng(seed)
    shapes = japi.cache_schema(model["jcfg"], slots, T)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        shapes, is_leaf=lambda s: hasattr(s, "init"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_logits_match_jax(model, backend):
    jpol, tpol = _policies(backend)
    caches = _pool(model, 3, 16, seed=7)
    toks = np.array([5, 77, 200], np.int32)
    pos = np.array([3, 9, 15], np.int32)
    active = np.array([1.0, 0.0, 1.0], np.float32)
    jl, jc = JM.forward(model["jparams"], model["jcfg"],
                        tokens=jnp.asarray(toks), mode="decode",
                        caches=jax.tree_util.tree_map(jnp.asarray, caches),
                        positions=jnp.asarray(pos), sp=model["jsp"],
                        policy=jpol, token_weights=jnp.asarray(active))
    tcaches = P.from_numpy(caches)
    tl, _ = TM.forward(model["params"], model["cfg"],
                       tokens=torch.from_numpy(toks), mode="decode",
                       caches=tcaches, positions=torch.from_numpy(pos),
                       sp=model["sp"], policy=tpol,
                       token_weights=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(P.to_numpy(tcaches))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunk_logits_match_jax(model, backend):
    jpol, tpol = _policies(backend)
    caches = _pool(model, 2, 32, seed=8)
    toks = np.random.default_rng(9).integers(0, 256, (1, 8))
    weights = np.array([1] * 6 + [0] * 2, np.float32)
    off, slot = 5, 1
    jl, jc = JM.forward(model["jparams"], model["jcfg"],
                        tokens=jnp.asarray(toks), mode="chunk",
                        caches=jax.tree_util.tree_map(jnp.asarray, caches),
                        positions=jnp.full((1,), off, jnp.int32),
                        slot=jnp.int32(slot), sp=model["jsp"], policy=jpol,
                        token_weights=jnp.asarray(weights))
    tcaches = P.from_numpy(caches)
    tl, _ = TM.forward(model["params"], model["cfg"],
                       tokens=torch.from_numpy(toks), mode="chunk",
                       caches=tcaches, positions=torch.full((1,), off),
                       slot=torch.tensor(slot),
                       sp=model["sp"], policy=tpol,
                       token_weights=torch.from_numpy(weights))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(P.to_numpy(tcaches))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)


def test_train_logits_match_jax(model):
    toks = np.random.default_rng(10).integers(0, 256, (2, 10))
    jl, _ = JM.forward(model["jparams"], model["jcfg"],
                       tokens=jnp.asarray(toks), mode="train")
    tl, none = TM.forward(model["params"], model["cfg"],
                          tokens=torch.from_numpy(toks), mode="train")
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)


def test_unported_paths_raise(model):
    """An unknown forward mode raises.  The VLM and enc-dec families,
    once refused whole, build the reference's schema (key paths and
    shapes, whisper's encoder and cross leaves among them); only the
    chunk mode, which no reference entry point reaches on them, still
    refuses them."""
    with pytest.raises(NotImplementedError, match="forward mode"):
        TM.forward(model["params"], model["cfg"],
                   tokens=torch.zeros(1, 2, dtype=torch.long), mode="encode")
    for arch in ("internvl2_26b", "whisper_large_v3"):
        jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        want = P.tree_flatten_with_path(_np(japi.init_model(jcfg, 0)))
        params = api.init_model(cfg, 0, device="cpu")
        got = P.tree_flatten_with_path(params)
        assert [(p, tuple(t.shape)) for p, t in got] == \
            [(p, a.shape) for p, a in want]
        with pytest.raises(NotImplementedError, match=cfg.family):
            TM.forward(params, cfg, tokens=torch.zeros(1, 2, dtype=torch.long),
                       mode="chunk",
                       caches=api.init_caches(cfg, 1, 8, device="cpu"),
                       positions=torch.zeros(1, dtype=torch.long),
                       slot=torch.tensor(0))
