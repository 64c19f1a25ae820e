"""jamba_v01_52b at its published expert count: one period (the first 8
of its 32 layers, the layer pattern once) as ``chip_smoke.py`` phase 24
serves it on the card, held here against the JAX package where it can
run on the CPU.

* The period's config is field-equal to the JAX config cut the same
  way: 7 mamba mixers and one attention layer, 4 dense and 4 MoE FFNs.
* ``models/moe.moe_apply`` at ``reduced()`` widths with the published
  16 experts, top-2 (``reduced()`` caps them at 4), against the JAX
  ``moe_apply`` on a group of 128 tokens, where some experts overflow
  their capacity: outputs within 1e-5 (f32) and the same dropped
  assignments.
* The engine's greedy tokens on reduced jamba with 16 experts equal the
  JAX engine's under ``off`` and ``pallas``
  (``tests/test_torch_ssm_engine.check_tokens``'s trace).
* ``chip_smoke.pass_launches`` on the period gives 58 launches of each
  2-D kernel and 12 of each ``_experts`` kernel per sparse pass, and
  ``launch/roofline.step_costs``' dense decode bytes equal the schema's
  parameter bytes less the embedding table, plus what the step reads
  besides (reckoned here on meta tensors: no weight is allocated).

Attention, router and expert weights are scaled by
``chip_smoke.GEMMA_WEIGHT_SCALE`` in the MoE test, as
``tests/test_torch_moe.py`` does, so the routing is far from uniform.
The port runs on one intra-op thread (``torch_threads``).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_calib_parity as C
from torch_threads import one_thread_module  # noqa: F401 (autouse)
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import moe as jmoe
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.launch.roofline import step_costs
from repro_torch.models import api
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig
from repro_torch.sparsity import SparsityPolicy

_HERE = pathlib.Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", _HERE.parent / "chip_smoke.py")
ssm_engine_checks = _load("ssm_engine_checks",
                          _HERE / "test_torch_ssm_engine.py")

ARCH = "jamba_v01_52b"
PERIOD = 8
EXPERTS = 16
TOL = 1e-5


def _period(cfg):
    return dataclasses.replace(cfg, num_layers=PERIOD)


def _with_experts(cfg):
    return dataclasses.replace(cfg, num_experts=EXPERTS)


_MODELS = {}


def _model():
    """Reduced jamba with 16 experts in both packages, and one init of
    it as JAX arrays: the port's, carried across as numpy (the JAX
    init compiles every leaf's sampler, about 9 s of this file)."""
    if not _MODELS:
        jcfg = _with_experts(jreduced(jget_config(ARCH)))
        cfg = _with_experts(reduced(get_config(ARCH)))
        assert cfg.__dict__ == jcfg.__dict__
        params = P.to_numpy(api.init_model(cfg, 0, device="cpu"))
        _MODELS.update(jcfg=jcfg, cfg=cfg, jparams=jax.tree_util.tree_map(
            jnp.asarray, params))
    return _MODELS["jcfg"], _MODELS["cfg"], _MODELS["jparams"]


def test_the_period_is_field_equal_to_the_jax_config():
    jcfg, cfg = _period(jget_config(ARCH)), _period(get_config(ARCH))
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.layer_groups() == jcfg.layer_groups()
    assert cfg == chip_smoke.served_config(ARCH)
    mixers = [m for m, _ in cfg.layer_kinds()]
    ffns = [f for _, f in cfg.layer_kinds()]
    assert (mixers.count("mamba"), mixers.count("attn")) == (7, 1)
    assert (ffns.count("moe"), ffns.count("dense")) == (4, 4)
    assert (cfg.num_experts, cfg.num_experts_padded,
            cfg.num_experts_per_tok) == (16, 16, 2)


def _scaled(jparams):
    """Attention, router and expert weights times GEMMA_WEIGHT_SCALE."""
    def f(path, a):
        keys = [getattr(p, "key", None) for p in path]
        return a * chip_smoke.GEMMA_WEIGHT_SCALE \
            if ("attn" in keys or "moe" in keys) else a
    return jax.tree_util.tree_map_with_path(f, jparams)


def _jax_dropped(jp, x, cfg, C_):
    """The reference's routing and positions in each expert
    (``src/repro/models/moe.py``'s router, top-k and stable sort by
    expert id) on x: (B, S, K) True where an assignment falls past the
    capacity."""
    logits = jnp.einsum("bsd,de->bse", x, jp["router"],
                        preferred_element_type=jnp.float32)
    _, topk = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                            cfg.num_experts_per_tok)
    B, S, K = topk.shape
    out = np.zeros((B, S * K), bool)
    for b in range(B):
        exp_id = topk[b].reshape(-1)
        order = jnp.argsort(exp_id, stable=True)
        exp_s = exp_id[order]
        counts = jnp.zeros((cfg.num_experts_padded,), jnp.int32).at[
            exp_s].add(1)
        pos = jnp.arange(S * K) - (jnp.cumsum(counts) - counts)[exp_s]
        out[b, np.asarray(order)] = np.asarray(pos >= C_)
    return out.reshape(B, S, K)


@pytest.mark.parametrize("backend", ["off", "pallas"])
def test_moe_apply_with_sixteen_experts_matches_jax(backend):
    """Layer 1's MoE FFN (reduced widths, 16 experts, top-2) on 2 groups
    of 128 tokens: capacity 21 against 16 assignments per expert on
    average, and some experts overflow (checked)."""
    jcfg, cfg, jparams = _model()
    assert cfg.layer_kinds()[1] == ("mamba", "moe")
    jparams = _scaled(jparams)
    jsp = jdefault_sp(jparams, jcfg, keep_frac=0.5)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["groups"][0]["l1"]["moe"])
    js = jax.tree_util.tree_map(lambda a: a[0], jsp[0]["l1"]["moe"])
    js = {k: {**v, "tau": jnp.full_like(v["tau"], 0.05)}
          for k, v in js.items()}
    tp, ts = P.from_numpy(C._np(jp)), P.from_numpy(C._np(js))
    x = np.random.default_rng(3).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    kw = dict(k_max_frac=0.5, block=16)
    want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, js, policy=JPolicy.uniform(
        backend, interpret=True, **kw))
    got = moe.moe_apply(tp, torch.from_numpy(x), cfg, ts,
                        policy=SparsityPolicy.uniform(backend, **kw))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    Cap = moe._capacity(128, cfg)
    assert Cap == jmoe._capacity(128, jcfg) == 21
    _, topk = moe.route(tp, torch.from_numpy(x), cfg)
    _, pos, counts = moe.dispatch(topk, 128, Cap, cfg.num_experts_padded)
    dropped = (pos >= Cap).numpy()
    assert np.array_equal(dropped, _jax_dropped(jp, jnp.asarray(x), jcfg,
                                                Cap))
    assert dropped.any() and int((counts > Cap).sum()) > 0


@pytest.mark.parametrize("backend", ["off", "pallas"])
def test_engine_with_sixteen_experts_matches_the_jax_engine(backend):
    """Reduced jamba with its published 16 experts: whole-prompt
    prefill of three ragged prompts, then batched decode with a free
    slot, greedy tokens equal to the JAX engine's."""
    checks = ssm_engine_checks
    jcfg, cfg, jparams = _model()
    params = P.from_numpy(C._np(jparams))
    tau = checks.TAUS[backend]
    jsp = None if tau is None else checks._with_tau(
        jdefault_sp(jparams, jcfg, keep_frac=0.5), tau)
    kw = dict(k_max_frac=0.5, block=16)
    ekw = dict(checks.TRACE, prefill_dense_frac=0.5)
    jeng = JEngine(jparams, jcfg, JEngineConfig(
        policy=JPolicy.uniform(backend, interpret=True, **kw), **ekw), jsp)
    teng = Engine(params, cfg, EngineConfig(
        policy=SparsityPolicy.uniform(backend, **kw), **ekw),
        None if jsp is None else P.from_numpy(C._np(jsp)), device="cpu")
    assert teng.prefill_strategy == jeng.prefill_strategy == "whole"
    ps = checks.prompts()
    jout, tout = checks.run(jeng, ps), checks.run(teng, ps)
    assert tout == jout
    assert all(len(t) == checks.GEN for t in tout.values())
    assert len({x for t in tout.values() for x in t}) > 12
    assert teng.decode_graphs.builds == 1


def test_launches_and_dense_decode_bytes_of_the_period():
    """Per sparse pass: 7 mamba mixers x 6 + 4 attention + 4 dense FFNs
    x 3 = 58 of each 2-D kernel, and 4 MoE FFNs x 3 = 12 of each
    ``_experts`` kernel.  The dense decode step at 8 slots reads every
    parameter but the embedding table once (the LM head is untied), the
    8 embedding rows, the attention layer's K and V over the pool, and
    each mamba layer's conv windows and f32 state, read and written."""
    cfg = _period(get_config(ARCH))
    assert chip_smoke.pass_launches(cfg) == {
        "score_select": 58, "sparse_matmul_shared": 58,
        "score_select_experts": 12, "sparse_matmul_shared_experts": 12}
    params = P.abstract_params(M.model_schema(cfg), cfg.dtype)
    leaves = P.tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert not cfg.tie_embeddings and "lm_head" in params
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    elem = params["embed"].element_size()
    ecfg = EngineConfig(**chip_smoke.JAMBA_ECFG)
    S, T, d = ecfg.max_slots, ecfg.pool_len, cfg.d_model
    kinds = cfg.layer_kinds()
    mamba = sum(m == "mamba" for m, _ in kinds)
    attn = sum(m == "attn" for m, _ in kinds)
    conv_c = cfg.d_inner + 2 * cfg.ssm_state
    state = 2 * S * ((cfg.ssm_conv - 1) * conv_c * elem
                     + cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4)
    kv = 2 * S * cfg.num_kv_heads * cfg.head_dim * T * elem
    want = (param_bytes - params["embed"].numel() * elem + S * d * elem
            + mamba * state + attn * kv)
    _, got = step_costs(cfg, ecfg, SparsityPolicy.dense(), None, "decode")
    assert got == want
    # under uncalibrated pallas (k_max_frac 0.5) the projections read
    # half their channel blocks: about half the bytes
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    _, sparse = step_costs(cfg, ecfg, SparsityPolicy.uniform(
        "pallas", k_max_frac=0.5), sp, "decode")
    assert 0.5 < sparse / got < 0.55


def test_whole_prefill_forms_of_the_period(monkeypatch):
    """Phase 24's expected forms per sparse whole prefill of the period:
    every expert projection's selection in the spread form (4 MoE layers
    x 3 = 12) from the 111 rows per expert of its shortest prompt (704
    tokens) on, none at decode or 32-token-chunk rows; its check
    (``chip_smoke.check_whole_forms``) takes a run's counts that match
    and refuses one short of them."""
    from repro_torch.kernels import sparse_matmul as K
    cfg = _period(get_config(ARCH))
    for tokens in (704, 1536, 4096):
        R = moe.expert_rows(cfg, 1, tokens)
        assert chip_smoke.expert_spread_forms(K, cfg, R) == 12, R
    for groups, tokens in ((8, 1), (1, 32)):
        R = moe.expert_rows(cfg, groups, tokens)
        assert chip_smoke.expert_spread_forms(K, cfg, R) == 0, R
    tiles, spread = chip_smoke.whole_prefill_forms(K, cfg, 4096)
    monkeypatch.setitem(K.tile_launches, "sparse_matmul_shared", tiles)
    monkeypatch.setitem(K.spread_launches, "score_select", spread)
    monkeypatch.setitem(K.spread_launches, "score_select_experts", 12)
    prefills = [(4096, 1, 0.0)]
    assert chip_smoke.check_whole_forms("period", K, cfg, prefills, True) \
        == (tiles, spread, 12)
    monkeypatch.setitem(K.spread_launches, "score_select_experts", 11)
    with pytest.raises(AssertionError, match="11 spread-form expert"):
        chip_smoke.check_whole_forms("period", K, cfg, prefills, True)
