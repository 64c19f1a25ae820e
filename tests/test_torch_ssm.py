"""The port's Mamba2 SSD block and the SSM archs against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
and the port's: the chunked SSD scan at every kind of chunk length the
reference's rule gives (L = 1 on a prime length, a proper divisor, the
whole sequence when it is shorter than the chunk), the depthwise causal
conv and its decode step, the conv tails a short prefill leaves,
``mamba_apply`` in train, prefill and decode, and the logits of reduced
mamba2_130m in prefill and over 8 decode steps under four backends
(``check_prefill_and_decode``, which ``tests/test_torch_jamba.py`` runs
on reduced jamba_v01_52b).  Weights are
initialised by JAX and carried across by ``models/params.from_numpy``.
Tolerance 1e-5 (f32) unless a case states otherwise; the ``pallas``
backend runs the JAX kernels in interpret mode and the port's plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import unstacked as JU
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import api as japi
from repro.models import model as JM
from repro.models import params as JP
from repro.models import ssm as jssm
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline
from repro_torch.core import unstacked as TU
from repro_torch.models import api
from repro_torch.models import model as TM
from repro_torch.models import params as P
from repro_torch.models import ssm
from repro_torch.sparsity import SparsityPolicy, calibrate_ladder
from torch_threads import one_thread_module  # noqa: F401 (autouse)

TOL = 1e-5
ARCHS = ["mamba2_130m", "jamba_v01_52b"]


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


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        jparams = japi.init_model(jcfg, 0)
        jsp = jdefault_sp(jparams, jcfg, keep_frac=0.5)
        _MODELS[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jsp=jsp,
                             params=P.from_numpy(_np(jparams)))
    return _MODELS[arch]


def _layer(m, r=0):
    """The first group's first mamba layer, rep ``r``: (jax params, port
    params)."""
    j = next(j for j, (mixer, _) in enumerate(m["cfg"].layer_pattern)
             if mixer == "mamba")
    jp = jax.tree_util.tree_map(lambda a: a[r],
                                m["jparams"]["groups"][0][f"l{j}"]["mamba"])
    tp = P.tree_map(lambda a: a[r], m["params"]["groups"][0][f"l{j}"]["mamba"])
    return jp, tp


# ---------------------------------------------------------------------------
# the SSD scan and the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,L", [(17, 1), (24, 12), (40, 10), (5, 5)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_jax(S, L, carried):
    """chunk 16: a prime S falls to L = 1, 24 to 12, 40 to 10, and S = 5
    < chunk runs as one chunk; with and without a carried state."""
    assert ssm.chunk_len(S, 16) == L
    rng = np.random.default_rng(S)
    B, H, Pd, N = 2, 3, 4, 5
    xh = rng.standard_normal((B, S, H, Pd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, Pd, N)).astype(np.float32) \
        if carried else None
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), 16,
                              init_state=None if s0 is None else
                              jnp.asarray(s0))
    ty, ts = ssm.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), 16,
                             init_state=None if s0 is None else
                             torch.from_numpy(s0))
    _close(ty, jy, 1e-4)
    _close(ts, js, 1e-4)
    assert ts.dtype == torch.float32


def test_ssd_chunked_keeps_bf16_y_and_f32_state():
    rng = np.random.default_rng(3)
    xh = torch.from_numpy(rng.standard_normal((1, 24, 2, 4)).astype(
        np.float32)).bfloat16()
    dt = torch.full((1, 24, 2), 0.1)
    y, s = ssm.ssd_chunked(xh, dt, -torch.ones(2), torch.ones(1, 24, 3),
                           torch.ones(1, 24, 3), 16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert y.shape == (1, 24, 2, 4) and s.shape == (1, 2, 4, 3)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_causal_conv_and_step_match_jax(dtype):
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32) * 0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ju, jw = jnp.asarray(u, jdt), jnp.asarray(w, jdt)
    tu, tw = torch.from_numpy(u).to(tdt), torch.from_numpy(w).to(tdt)
    got = ssm._causal_conv(tu, tw)
    assert got.dtype == tdt
    _close(got, np.asarray(jssm._causal_conv(ju, jw), np.float32), 1e-5
           if tdt == torch.float32 else 1e-2)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jo, js = jssm._conv_step(jnp.asarray(state, jdt), ju[:, 0], jw)
    to, ts = ssm._conv_step(torch.from_numpy(state).to(tdt), tu[:, 0], tw)
    _close(to, np.asarray(jo, np.float32), 1e-5 if tdt == torch.float32
           else 1e-2)
    assert torch.equal(ts.float(), torch.from_numpy(
        np.array(js, np.float32)))


@pytest.mark.parametrize("S", [1, 2, 3, 7])
def test_prefill_conv_tails_match_jax(S):
    """The conv caches a prefill leaves hold the last W - 1 = 3
    pre-activation inputs, left-padded with zeros when S < 3."""
    m = _model("mamba2_130m")
    jp, tp = _layer(m)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    jo, jc = jssm.mamba_apply(jp, jnp.asarray(x), m["jcfg"], mode="prefill")
    to, tc = ssm.mamba_apply(tp, torch.from_numpy(x), m["cfg"],
                             mode="prefill")
    _close(to, jo)
    for k in ("conv_x", "conv_B", "conv_C", "ssm"):
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k])
    if S < 3:
        assert torch.all(tc["conv_x"][:, :3 - S] == 0)


# ---------------------------------------------------------------------------
# mamba_apply and the SSM params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "pallas"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_matches_jax(mode, backend):
    """Decode against a random pool state with one inactive row (its
    token weight 0 in the shared saliency); the port writes the new conv
    windows and state into the cache it was given."""
    m = _model("mamba2_130m")
    jp, tp = _layer(m)
    jsp_l = jax.tree_util.tree_map(
        lambda a: a[0], _with_tau(m["jsp"], -jnp.inf)[0]["l0"]["mamba"])
    tsp_l = P.from_numpy(_np(jsp_l))
    jpol = JPolicy.uniform(backend, k_max_frac=0.5, block=16, interpret=True)
    tpol = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    rng = np.random.default_rng(7)
    cfg = m["cfg"]
    if mode == "decode":
        B = 3
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        cache = {"conv_x": rng.standard_normal((B, 3, cfg.d_inner)),
                 "conv_B": rng.standard_normal((B, 3, cfg.ssm_state)),
                 "conv_C": rng.standard_normal((B, 3, cfg.ssm_state)),
                 "ssm": rng.standard_normal((B, cfg.ssm_nheads,
                                             cfg.ssm_head_dim,
                                             cfg.ssm_state))}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
        tw = np.array([1.0, 0.0, 1.0], np.float32)
        jo, jc = jssm.mamba_apply(jp, jnp.asarray(x), m["jcfg"], jsp_l,
                                  {k: jnp.asarray(v) for k, v in cache.items()},
                                  "decode", policy=jpol,
                                  token_weights=jnp.asarray(tw))
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        to, tc = ssm.mamba_apply(tp, torch.from_numpy(x), cfg, tsp_l, tcache,
                                 "decode", policy=tpol,
                                 token_weights=torch.from_numpy(tw))
        assert tc is tcache                       # written in place
        for k in cache:
            _close(tc[k], jc[k])
    else:
        x = rng.standard_normal((2, 21, 64)).astype(np.float32)
        jo, jc = jssm.mamba_apply(jp, jnp.asarray(x), m["jcfg"], jsp_l,
                                  mode=mode, policy=jpol)
        to, tc = ssm.mamba_apply(tp, torch.from_numpy(x), cfg, tsp_l,
                                 mode=mode, policy=tpol)
        assert (tc is None) == (jc is None) == (mode == "train")
        if mode == "prefill":
            for k in jc:
                _close(tc[k], jc[k])
    _close(to, jo)


def test_ssm_params_and_schema_match_jax():
    """The SSM inits (A_log = log U[1, 16], dt_bias = softplus^-1 U[1e-3,
    1e-1]) stay f32 in a bf16 model; the schema is the reference's
    (no ln2 on an ("mamba", "none") layer; jamba's 8-layer period)."""
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        jschema = JM.model_schema(jreduced(jget_config(arch)))
        tschema = TM.model_schema(cfg)
        assert P.tree_map(lambda s: (s.shape, s.init, s.dtype), tschema) == \
            jax.tree_util.tree_map(lambda s: (s.shape, s.init, s.dtype),
                                   jschema, is_leaf=JP._is_spec)
    cfg = get_config("mamba2_130m")
    layer = TM.layer_schema(cfg, ("mamba", "none"))
    assert set(layer) == {"ln1", "mamba"}
    schema = TM.model_schema(reduced(cfg))
    params = P.init_params(schema, 0, "bfloat16")
    mb = params["groups"][0]["l0"]["mamba"]
    for k in ("A_log", "D", "dt_bias"):
        assert mb[k].dtype == torch.float32
    assert mb["in_x"].dtype == mb["norm"].dtype == torch.bfloat16
    a = torch.exp(mb["A_log"])
    assert torch.all((a >= 1.0) & (a <= 16.0))
    dt = torch.nn.functional.softplus(mb["dt_bias"])
    assert torch.all((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001))
    assert not torch.equal(mb["A_log"][0], mb["A_log"][1])
    again = P.init_params(schema, 0, "bfloat16")
    assert torch.equal(again["groups"][0]["l0"]["mamba"]["dt_bias"],
                       mb["dt_bias"])


# ---------------------------------------------------------------------------
# reduced mamba2_130m and jamba: logits against JAX
# ---------------------------------------------------------------------------

TAUS = {"off": None, "mask": 0.05, "topk_shared": None, "pallas": -np.inf}


@pytest.mark.parametrize("backend", ["off", "mask", "topk_shared", "pallas"])
def test_logits_in_prefill_and_decode_match_jax(backend):
    """Reduced mamba2_130m (reduced jamba: ``tests/test_torch_jamba.py``)."""
    check_prefill_and_decode(_model("mamba2_130m"), backend)


def check_prefill_and_decode(m, backend):
    """Prefill of 2 x 19 tokens, then 8 decode steps of both rows from
    the prefill caches (inserted into a 3-slot pool, slot 1 inactive),
    under ``backend``: logits at 1e-5 and the caches after the last step
    (an attention layer's K/V written at each row's position)."""
    jcfg, cfg = m["jcfg"], m["cfg"]
    tau = TAUS[backend]
    jsp = m["jsp"] if tau is None else _with_tau(m["jsp"], tau)
    sp = P.from_numpy(_np(jsp))
    jpol = JPolicy.uniform(backend, k_max_frac=0.5, block=16, interpret=True)
    tpol = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (2, 19))
    # the reference's steps jitted, as its engine runs them (one trace of
    # each: op-by-op interpretation of the Pallas kernels takes minutes)
    jprefill = jax.jit(lambda p, t, s: JM.forward(
        p, jcfg, tokens=t, mode="prefill", sp=s, policy=jpol))
    jdecode = jax.jit(lambda p, t, c, pos, s, tw: JM.forward(
        p, jcfg, tokens=t, mode="decode", caches=c, positions=pos, sp=s,
        policy=jpol, token_weights=tw))
    jl, jc = jprefill(m["jparams"], jnp.asarray(toks), jsp)
    tl, tc = TM.forward(m["params"], cfg, tokens=torch.from_numpy(toks),
                        mode="prefill", sp=sp, policy=tpol)
    _close(tl, jl)
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(P.to_numpy(tc))):
        _close(b, a)
    # a 3-slot pool at 32 positions: rows 0 and 2 hold the prompts
    T = 32
    pool = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), japi.cache_schema(jcfg, 3, T),
        is_leaf=lambda s: hasattr(s, "init"))

    def put(pool_leaf, pref_leaf):
        out = pool_leaf.copy()
        if pref_leaf.ndim == pool_leaf.ndim and pool_leaf.shape[-1] == T \
                and pref_leaf.shape[-1] == 19:              # K (..., T)
            out[:, [0, 2], ..., :19] = pref_leaf
        elif pool_leaf.ndim == 5 and pool_leaf.shape[-2] == T and \
                pref_leaf.shape[-2] == 19:                  # V (..., T, hd)
            out[:, [0, 2], :, :19] = pref_leaf
        else:                                               # SSM: whole rows
            out[:, [0, 2]] = pref_leaf
        return out
    pool = jax.tree_util.tree_map(put, pool, _np(jc))
    jcaches = jax.tree_util.tree_map(jnp.asarray, pool)
    tcaches = P.from_numpy(pool)
    pos = np.array([19, 5, 19], np.int32)
    active = np.array([1.0, 0.0, 1.0], np.float32)
    nxt = np.stack([np.argmax(np.asarray(jl), -1)[0], 0,
                    np.argmax(np.asarray(jl), -1)[1]]).astype(np.int32)
    for _ in range(8):
        jl, jcaches = jdecode(m["jparams"], jnp.asarray(nxt), jcaches,
                              jnp.asarray(pos), jsp, jnp.asarray(active))
        tl, tcaches = TM.forward(
            m["params"], cfg, tokens=torch.from_numpy(nxt).long(),
            mode="decode", caches=tcaches,
            positions=torch.from_numpy(pos).long(), sp=sp, policy=tpol,
            token_weights=torch.from_numpy(active))
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + np.array([1, 0, 1], np.int32)
    for a, b in zip(jax.tree_util.tree_leaves(jcaches),
                    jax.tree_util.tree_leaves(P.to_numpy(tcaches))):
        _close(b, a)


@pytest.mark.parametrize("mode", ["chunk", "verify"])
def test_chunk_and_verify_refuse_ssm_layers(mode):
    m = _model("mamba2_130m")
    caches = api.init_caches(m["cfg"], 2, 16, device="cpu")
    kw = dict(positions=torch.zeros(2 if mode == "verify" else 1,
                                    dtype=torch.long))
    if mode == "chunk":
        kw["slot"] = torch.tensor(0)
    with pytest.raises(NotImplementedError) as texc:
        TM.forward(m["params"], m["cfg"],
                   tokens=torch.zeros((2 if mode == "verify" else 1, 4),
                                      dtype=torch.long),
                   mode=mode, caches=caches, **kw)
    with pytest.raises(NotImplementedError) as jexc:
        JM.layer_apply({}, jnp.zeros((1, 4, 64)), m["jcfg"],
                       ("mamba", "none"), mode=mode)
    assert str(texc.value) == str(jexc.value)
    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="SSM layers"):
            api.make_verify_step(reduced(get_config(arch)))
    assert not TM.chunkable(reduced(get_config("jamba_v01_52b")))


# ---------------------------------------------------------------------------
# unstacked execution and calibration
# ---------------------------------------------------------------------------

def test_unstacked_forward_and_blocks_match_jax():
    """Reduced mamba2_130m (reduced jamba: ``tests/test_torch_jamba.py``)."""
    check_unstacked(_model("mamba2_130m"))


def check_unstacked(m):
    """``forward_unstacked`` and ``block_forward`` over mamba (and
    jamba's attention and MoE) layers: the model's own ``layer_apply`` in
    train mode, against the JAX ones, dense and under ``mask``."""
    toks = np.random.default_rng(6).integers(0, 256, (2, 10))
    jl, jin = JU.forward_unstacked(m["jparams"], m["jcfg"],
                                   jnp.asarray(toks),
                                   collect_block_inputs=True)
    tl, tin = TU.forward_unstacked(m["params"], m["cfg"],
                                   torch.from_numpy(toks),
                                   collect_block_inputs=True)
    _close(tl, jl)
    assert len(tin) == len(jin) == m["cfg"].num_layers
    jlayers = JU.unstack_layers(m["jcfg"], m["jparams"])
    tlayers = TU.unstack_layers(m["cfg"], m["params"])
    jsp = JU.default_layer_sp
    for d in (0, len(tlayers) - 1):
        assert tlayers[d].kind == tuple(jlayers[d].kind)
        jsp_d = _with_tau(jsp(jlayers[d].params), 0.05)
        tsp_d = P.from_numpy(_np(jsp_d))
        jo = JU.block_forward(jlayers[d], jin[d], m["jcfg"], jsp_d,
                              policy=JPolicy.uniform("mask"))
        to = TU.block_forward(tlayers[d], tin[d], m["cfg"], tsp_d,
                              policy=SparsityPolicy.uniform("mask"))
        _close(to, jo)


def test_calibration_refuses_ssm_archs():
    """(Named for the refusal it replaced.)  The pipeline and the ladder
    run on the archs with mamba layers: the plan meets its budget with
    finite taus wherever a linear is sparsified, its stacked sp tree
    serves the model under ``mask``, and the ladder's cold rung is the
    plan.  ``tests/test_torch_calibration_ssm.py`` and
    ``tests/test_torch_calibration_jamba.py`` hold them against JAX.
    On one intra-op thread, as the module's every test
    (``torch_threads``)."""
    from repro_torch.core.allocation import EvoConfig, weighted_average
    evo = EvoConfig(generations=1, offspring=2, eps=0.1)
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        params = api.init_model(cfg, 0, device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (2, 16))
        batch = {"tokens": toks}
        plan = pipeline.run_pipeline(params, cfg, batch, 0.5, evo=evo,
                                     delta=0.25, coord_passes=0)
        ctx = pipeline.build_context(params, cfg, batch)
        avg = weighted_average(ctx, np.asarray(plan.block_ratios))
        assert 0.5 - evo.eps <= avg <= 0.5 + 1e-9
        assert all(np.isfinite(plan.taus[k])
                   for k, r in plan.layer_ratios.items() if r > 0)
        logits, _ = TM.forward(params, cfg, tokens=torch.as_tensor(toks),
                               sp=plan.stacked_sp,
                               policy=SparsityPolicy.uniform("mask"))
        assert bool(torch.isfinite(logits).all())
        ladder = calibrate_ladder(params, cfg, batch, (0.0, 0.5),
                                  evo=evo, delta=0.25, coord_passes=0,
                                  backend="pallas")
        assert np.array_equal(ladder.block_ratios[1], plan.block_ratios)
