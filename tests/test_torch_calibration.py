"""The port's calibration slice (paper Alg. 1-4) against the JAX package.

Model: the reduced llama31_8b, initialised by JAX and carried across with
``models/params.from_numpy``, with the weight-column spike of
``tests/test_pipeline.py`` (random weights are isotropic, where weight-
aware and activation-only scores coincide).  Calibration tokens:
``SyntheticLM(DataConfig(V, 48, 2, seed=4)).batch(0)``.

Tolerances, each with its reason:

- synthetic batches, unstacked weights, restacked sp leaves, search
  outputs on a numpy stub: equal (the same numpy or copy code);
- logits 1e-5 (``tests/test_torch_model.py``'s), captured activations
  1e-5, column norms 1e-6: f32 sums in another order;
- ``tau_for`` on identical numpy activations rtol 1e-6: ``pow`` may
  differ by an ulp between numpy and torch;
- ``fitness`` / ``block_mse`` on one sp tree rtol 1e-4, and logits
  under ``mask`` 1e-5.  An Eq. 7 threshold is the value of one
  calibration score, so that element sits exactly on it, and whether
  the ``mask`` backend keeps it hangs on the last bit of activations
  that the two packages compute in another order: one such flip moved
  the block error by up to 0.6%.  So the sp tree (JAX's ``make_sp``,
  carried across) is made tie-free first: each finite threshold moves
  halfway down to the next lower calibration score, where no captured
  activation lies;
- ``run_pipeline`` ratios and alphas equal, taus rtol 1e-5.  The two
  pipelines run on activations that agree to 1e-5, not bitwise, so a
  near-tie in a search comparison can branch them apart.  With the data
  seeds 0-2 the greedy fine search branches that way, through the
  boundary element above; seed 4 has no such near-tie and also moves the
  coarse search off the uniform start.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import allocation as JA
from repro.core import alpha_search as JAS
from repro.core import calibration as JC
from repro.core import pipeline as JP
from repro.core import unstacked as JU
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import eval_batch as jeval_batch
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.core import allocation as TA
from repro_torch.core import alpha_search as TAS
from repro_torch.core import calibration as TC
from repro_torch.core import pipeline as TP
from repro_torch.core import sparse_linear as sl
from repro_torch.core import unstacked as TU
from repro_torch.data import DataConfig, SyntheticLM, eval_batch
from repro_torch.launch import serve
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig
from repro_torch.sparsity import CaptureSink, SparsityPolicy
from repro_torch.sparsity import policy as tpolicy

DATA_SEED = 4
QUICK = dict(delta=0.25, coord_passes=0)     # the serve CLI's --calib-quick


def _spike(path, a):
    """tests/test_pipeline.py's weight-column outliers (paper Obs. 1)."""
    name = str(path[-1].key) if hasattr(path[-1], "key") else ""
    if name in JU.SPARSIFIABLE and a.ndim >= 3:   # stacked (reps, n, m)
        n = a.shape[-2]
        key = jax.random.fold_in(jax.random.PRNGKey(7), n)
        mask = jax.random.bernoulli(key, 0.1, (n,))
        scale = jnp.where(mask, 4.0, 1.0).astype(a.dtype)
        return a * scale[..., :, None]
    return a


def _t(tree):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _tie_free_sp(jctx, alphas, ratios):
    """JAX's make_sp with each finite tau moved halfway down to the next
    lower calibration score (see the module docstring)."""
    sp = jctx.make_sp(alphas, ratios)
    for d, spd in enumerate(sp):
        for path in jctx.keys_by_depth[d]:
            key = (d, path)
            tau = float(JU.get_sp_leaf(spd, path)["tau"])
            if np.isfinite(tau):
                s = jctx.scores_for(key, alphas[key])
                i = int(np.searchsorted(s, np.float32(tau)))
                low = float(s[i - 1]) if i > 0 else 0.0
                JU.set_sp_leaf(spd, path, "tau", 0.5 * (low + tau))
    return sp


@pytest.fixture(scope="module")
def m():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = jax.tree_util.tree_map_with_path(_spike,
                                               japi.init_model(jcfg, 0))
    toks = SyntheticLM(DataConfig(jcfg.vocab_size, 48, 2,
                                  seed=DATA_SEED)).batch(0)
    cfg = reduced(get_config("llama31_8b"))
    params = _t(jparams)
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                toks=toks,
                jctx=JC.build_context(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks)}),
                tctx=TC.build_context(params, cfg, {"tokens": toks}))


@pytest.fixture(scope="module")
def plans(m):
    """One --calib-quick-budget plan from each package."""
    evo = dict(generations=1, offspring=2, eps=0.1)
    jp = JP.run_pipeline(m["jparams"], m["jcfg"], None, 0.5,
                         evo=JA.EvoConfig(**evo), ctx=m["jctx"], **QUICK)
    tp = TP.run_pipeline(m["params"], m["cfg"], None, 0.5,
                         evo=TA.EvoConfig(**evo), ctx=m["tctx"], **QUICK)
    return jp, tp


# ---------------------------------------------------------------------------
# data, unstacking, capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,seq,batch,seed,step", [
    (256, 48, 2, 4, 0), (128256, 128, 4, 0, 0), (1000, 70, 3, 9, 5)])
def test_synthetic_batches_bit_equal(V, seq, batch, seed, step):
    tb = SyntheticLM(DataConfig(V, seq, batch, seed=seed)).batch(step)
    jb = JSyntheticLM(JDataConfig(V, seq, batch, seed=seed)).batch(step)
    assert tb.dtype == jb.dtype and np.array_equal(tb, jb)
    assert np.array_equal(eval_batch(DataConfig(V, seq, batch, seed=seed)),
                          jeval_batch(JDataConfig(V, seq, batch, seed=seed)))


def test_unstack_layers_and_restack_sp_leaves_equal(m):
    jl = JU.unstack_layers(m["jcfg"], m["jparams"])
    tl = TU.unstack_layers(m["cfg"], m["params"])
    assert [(d.depth, d.kind, d.group, d.rep, d.pos) for d in tl] == \
        [(d.depth, tuple(d.kind), d.group, d.rep, d.pos) for d in jl]
    for a, b in zip(jl, tl):
        for path, leaf in jax.tree_util.tree_leaves_with_path(a.params):
            node = b.params
            for k in path:
                node = node[k.key]
            assert np.array_equal(np.asarray(leaf), node.numpy())
    assert [p for p, _ in TU.sparsifiable_leaves(tl[0].params)] == \
        [p for p, _ in JU.sparsifiable_leaves(jl[0].params)]
    jsp = m["jctx"].make_sp({}, {k: 0.5 for k in m["jctx"].acts})
    want = JU.restack_sp(m["jcfg"], jsp)
    got = TU.restack_sp(m["cfg"], [_t(s) for s in jsp])
    flat_w, flat_g = tpolicy._flatten_sp(_t(want)), tpolicy._flatten_sp(got)
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        assert np.array_equal(flat_w[k], flat_g[k]), k


def test_forward_unstacked_logits_match(m):
    toks = m["toks"]
    jl, _ = JU.forward_unstacked(m["jparams"], m["jcfg"], jnp.asarray(toks))
    tl, _ = TU.forward_unstacked(m["params"], m["cfg"],
                                 torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    # under the mask policy with one tie-free sp tree
    keys = list(m["jctx"].acts)
    jsp = _tie_free_sp(m["jctx"], {k: 0.7 for k in keys},
                       {k: 0.5 for k in keys})
    mask = JPolicy.uniform("mask")
    jl, _ = JU.forward_unstacked(m["jparams"], m["jcfg"], jnp.asarray(toks),
                                 per_depth_sp=jsp, policy=mask)
    tl, _ = TU.forward_unstacked(m["params"], m["cfg"],
                                 torch.from_numpy(toks).long(),
                                 per_depth_sp=[_t(s) for s in jsp],
                                 policy=SparsityPolicy.uniform("mask"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def test_captured_acts_g_and_block_io_match(m):
    jctx, tctx = m["jctx"], m["tctx"]
    assert tctx.keys_by_depth == jctx.keys_by_depth
    assert tctx.sizes == jctx.sizes
    assert list(tctx.acts) == list(jctx.acts)
    assert len(tctx.block_io) == len(jctx.block_io) == tctx.num_blocks + 1
    for k in jctx.acts:
        np.testing.assert_allclose(tctx.acts[k].numpy(), jctx.acts[k],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tctx.g[k].numpy(), jctx.g[k], rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(tctx.block_io, jctx.block_io):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tctx.dense_logits.numpy(),
                               np.asarray(jctx.dense_logits), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["off", "mask", "topk_shared",
                                     "topk_block", "pallas"])
def test_capture_records_before_dispatch_on_every_backend(backend):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    cap = CaptureSink()
    pol = SparsityPolicy.uniform(backend, k_max_frac=0.5, capture=cap)
    sl.project(x, w, sl.default_sp(w), policy=pol)
    assert len(cap) == 1
    wid, xc = next(iter(cap))
    assert wid == id(w) and torch.equal(xc, x) and not xc.requires_grad


def test_unported_calibration_inputs_raise(m):
    with pytest.raises(NotImplementedError):
        TU.forward_unstacked(m["params"], m["cfg"], torch.zeros(1, 4).long(),
                             frames=torch.zeros(1))
    with pytest.raises(NotImplementedError):
        TU.unstack_layers(reduced(get_config("mamba2_130m")), {})


# ---------------------------------------------------------------------------
# Eq. 7 thresholds, Eq. 8 fitness, Eq. 6 block error
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.35, 0.7, 1.0, 1.5])
def test_tau_for_matches_on_identical_inputs(m, alpha):
    """Both packages' tau_for on the same numpy activations and g."""
    jctx = m["jctx"]
    tctx = dataclasses.replace(
        m["tctx"], acts={k: torch.from_numpy(v) for k, v in jctx.acts.items()},
        g={k: torch.from_numpy(np.array(v)) for k, v in jctx.g.items()},
        _tau_cache={})
    for key in list(jctx.acts)[::3]:
        for keep in (1.0, 0.9, 0.5, 0.25, 0.0):
            tj, tt = jctx.tau_for(key, alpha, keep), tctx.tau_for(key, alpha,
                                                                  keep)
            if keep == 1.0:
                assert tj == tt == -np.inf
            else:
                np.testing.assert_allclose(tt, tj, rtol=1e-6)


@pytest.mark.parametrize("alpha,seed", [(0.0, 0), (0.7, 1), (1.0, 2),
                                        (1.5, 3)])
def test_fitness_and_block_mse_match(m, alpha, seed):
    """The same tie-free per-depth sp tree in both packages."""
    jctx, tctx = m["jctx"], m["tctx"]
    rng = np.random.default_rng(seed)
    keys = list(jctx.acts)
    ratios = {k: float(rng.choice([0.25, 0.4, 0.5, 0.75, 1.0]))
              for k in keys}
    jsp = _tie_free_sp(jctx, {k: alpha for k in keys}, ratios)
    tsp = [_t(s) for s in jsp]
    np.testing.assert_allclose(tctx.fitness(tsp), jctx.fitness(jsp),
                               rtol=1e-4)
    for d in range(jctx.num_blocks):
        np.testing.assert_allclose(tctx.block_mse(d, tsp[d]),
                                   jctx.block_mse(d, jsp[d]), rtol=1e-4)


def test_make_sp_sets_every_leaf(m):
    tctx = m["tctx"]
    keys = list(tctx.acts)
    sp = tctx.make_sp({k: 0.5 for k in keys}, {k: 0.75 for k in keys})
    for d, spd in enumerate(sp):
        for path in tctx.keys_by_depth[d]:
            leaf = TU.get_sp_leaf(spd, path)
            assert leaf["alpha"].dtype == torch.float32 and \
                leaf["alpha"].dim() == 0
            assert float(leaf["keep_frac"]) == 0.75
            assert float(leaf["tau"]) == pytest.approx(
                tctx.tau_for((d, path), 0.5, 0.75))


def test_bf16_ties_at_alpha_zero_keep_more_than_the_budget(m):
    """A reference behaviour both packages share: with bf16 activations
    many scores tie at alpha 0, and ``s >= tau`` keeps every tie, so more
    channels than the keep ratio survive; at alpha > 0 the g^alpha factor
    breaks the ties.  The alpha grid search then favours alpha 0."""
    cfg = dataclasses.replace(m["cfg"], dtype="bfloat16")
    params = P.tree_map(lambda t: t.to(torch.bfloat16), m["params"])
    tctx = TC.build_context(params, cfg, {"tokens": m["toks"]})
    jctx = dataclasses.replace(
        m["jctx"], acts={k: v.float().numpy() for k, v in tctx.acts.items()},
        g={k: v.numpy() for k, v in tctx.g.items()}, _tau_cache={})
    kept, target = {0.0: 0, 1.0: 0}, 0
    for key, x in tctx.acts.items():
        target += x.numel() // 2
        for alpha in kept:
            tau = tctx.tau_for(key, alpha, 0.5)
            assert tau == jctx.tau_for(key, alpha, 0.5)
            s = sl.scores(x, tctx.g[key], torch.tensor(alpha))
            kept[alpha] += int((s >= tau).sum())
    assert kept[0.0] > target + 50
    assert abs(kept[1.0] - target) <= len(tctx.acts)


# ---------------------------------------------------------------------------
# Alg. 2-4 search logic on a numpy stub context
# ---------------------------------------------------------------------------

PATHS = ("attn/wk", "attn/wo", "attn/wq", "attn/wv", "mlp/wi_gate",
         "mlp/wi_up", "mlp/wo")


class StubContext:
    """A numpy stand-in for a calibration context: fitness and block
    error are fixed functions of the ratio and alpha maps, so both
    packages' search code sees the very same numbers."""

    def __init__(self, n_blocks: int, seed: int):
        rng = np.random.default_rng(seed)
        self.keys_by_depth = {d: list(PATHS) for d in range(n_blocks)}
        self.layers = [None] * n_blocks
        keys = [(d, p) for d in range(n_blocks) for p in PATHS]
        self.sizes = {k: float(s) * (1 + k[0] % 3) for k, s in
                      zip(keys, np.tile([4, 16, 16, 4, 56, 56, 56],
                                        n_blocks))}
        self.c = {k: float(rng.uniform(0.1, 2.0)) for k in keys}
        self.a_opt = {k: float(rng.uniform(0.0, 1.5)) for k in keys}

    @property
    def num_blocks(self):
        return len(self.layers)

    def block_weight(self, d):
        return sum(self.sizes[(d, p)] for p in self.keys_by_depth[d])

    def make_sp(self, alphas, ratios):
        return dict(alphas), dict(ratios)

    def _err(self, sp, keys):
        alphas, ratios = sp
        return float(sum(self.c[k] * (1.0 - ratios.get(k, 1.0)) ** 2 * (
            1.0 + (alphas.get(k, 0.0) - self.a_opt[k]) ** 2) for k in keys))

    def fitness(self, sp):
        return self._err(sp, self.c)

    def block_mse(self, depth, sp):
        return self._err(sp, [(depth, p) for p in self.keys_by_depth[depth]])


def _stub_sp(ctx, dl, alphas, ratios):
    return dict(alphas), dict(ratios)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocation_and_alpha_search_identical_on_stub(seed, monkeypatch):
    monkeypatch.setattr(JAS, "_sp_for_block", _stub_sp)
    monkeypatch.setattr(TAS, "_sp_for_block", _stub_sp)
    out = []
    for A, S in ((JA, JAS), (TA, TAS)):
        ctx = StubContext(6, seed)
        evo = A.EvoConfig(generations=6, offspring=4, eps=0.05, seed=seed)
        p = A.block_level_allocation(ctx, 0.5, evo)
        p_warm = A.block_level_allocation(ctx, 0.6, evo, p_init=p, p_min=p,
                                          generations=3)
        layer = {}
        for d in range(ctx.num_blocks):
            layer.update(A.intra_block_allocation(ctx, d, float(p[d]), 0.1))
        warm = A.intra_block_allocation(ctx, 0, float(p_warm[0]), 0.1,
                                        p_init=layer)
        keep = {k: 1.0 - v for k, v in layer.items()}
        alphas = S.search_all_alphas(ctx, keep, coord_passes=1)
        pb, per_linear = A.allocate(ctx, 0.4, evo, 0.2, alphas)
        out.append((p.tolist(), p_warm.tolist(), layer, warm, alphas,
                    pb.tolist(), per_linear,
                    A.weighted_average(ctx, p_warm)))
    assert out[0] == out[1]
    assert S.GRID == JAS.GRID


# ---------------------------------------------------------------------------
# Alg. 1 end to end
# ---------------------------------------------------------------------------

def test_run_pipeline_matches(plans):
    jp, tp = plans
    assert np.array_equal(tp.block_ratios, jp.block_ratios)
    assert not np.all(jp.block_ratios == 0.5)    # the coarse search moved
    assert tp.layer_ratios == jp.layer_ratios
    assert tp.alphas == jp.alphas
    assert tp.taus.keys() == jp.taus.keys()
    for k, t in jp.taus.items():
        if np.isfinite(t):
            np.testing.assert_allclose(tp.taus[k], t, rtol=1e-5)
        else:
            assert tp.taus[k] == t
    assert tp.summary() == jp.summary()


@pytest.mark.parametrize("flags", [
    dict(skip_coarse=True, skip_fine=True),
    dict(skip_alpha=True),
    dict(skip_coarse=True, skip_fine=True, skip_alpha=True,
         alpha_default=0.0)])
def test_run_pipeline_ablations_match(m, flags):
    evo = dict(generations=1, offspring=2, eps=0.1)
    jp = JP.run_pipeline(m["jparams"], m["jcfg"], None, 0.5,
                         evo=JA.EvoConfig(**evo), ctx=m["jctx"], **QUICK,
                         **flags)
    tp = TP.run_pipeline(m["params"], m["cfg"], None, 0.5,
                         evo=TA.EvoConfig(**evo), ctx=m["tctx"], **QUICK,
                         **flags)
    assert np.array_equal(tp.block_ratios, jp.block_ratios)
    assert (tp.layer_ratios, tp.alphas) == (jp.layer_ratios, jp.alphas)
    for k, t in jp.taus.items():
        np.testing.assert_allclose(tp.taus[k], t, rtol=1e-5)


def test_activation_only_plan_and_warm_start_match(m, plans):
    jp, tp = plans
    ja = JP.activation_only_plan(None, m["jcfg"], None, 0.5, ctx=m["jctx"])
    ta = TP.activation_only_plan(None, m["cfg"], None, 0.5, ctx=m["tctx"])
    assert (ta.layer_ratios, ta.alphas) == (ja.layer_ratios, ja.alphas)
    for k, t in ja.taus.items():
        np.testing.assert_allclose(ta.taus[k], t, rtol=1e-5)
    evo = dict(generations=1, offspring=2, eps=0.1)
    jw = JP.run_pipeline(None, m["jcfg"], None, 0.6,
                         evo=JA.EvoConfig(**evo), ctx=m["jctx"],
                         warm_start=jp, skip_alpha=True, **QUICK)
    tw = TP.run_pipeline(None, m["cfg"], None, 0.6, evo=TA.EvoConfig(**evo),
                         ctx=m["tctx"], warm_start=tp, skip_alpha=True,
                         **QUICK)
    assert np.array_equal(tw.block_ratios, jw.block_ratios)
    assert tw.layer_ratios == jw.layer_ratios
    with pytest.raises(ValueError, match="ascending"):
        TP.run_pipeline(None, m["cfg"], None, 0.4, ctx=m["tctx"],
                        warm_start=tp)


def test_plan_json_round_trip(plans, tmp_path):
    _, tp = plans
    tp.save(str(tmp_path / "plan.json"))
    p_target, br, lr, al, ta = TP.SparsePlan.load_ratios(
        str(tmp_path / "plan.json"))
    assert (p_target, lr, al, ta) == (tp.p_target, tp.layer_ratios,
                                      tp.alphas, tp.taus)
    assert np.array_equal(br, tp.block_ratios)


@pytest.mark.parametrize("kw", [dict(backend="pallas"),
                                dict(backend="topk_shared",
                                     sensitive_backend="mask",
                                     sensitive_frac=0.5),
                                dict(backend="mask", sensitive_backend="off",
                                     k_max_frac=0.75, block=16)])
def test_policy_from_plan_matches(plans, kw):
    jp, tp = plans
    jd = jp.to_policy(**kw).to_dict()
    td = tp.to_policy(**kw).to_dict()
    assert td == {**jd, "interpret": None}


# ---------------------------------------------------------------------------
# the self-contained artifact, across the two packages
# ---------------------------------------------------------------------------

TRACE = dict(max_slots=2, max_len=64, prefill_chunk=16)


def _serve(engine, prompts, gen=6):
    for p in prompts:
        engine.submit(p, gen)
    return engine.run()


@pytest.mark.parametrize("backend", ["mask", "pallas"])
def test_jax_artifact_serves_the_same_tokens(m, plans, backend, tmp_path):
    """A plan calibrated by JAX ships to the port: the npz that
    ``to_policy(...).save(path, sp=plan.stacked_sp)`` writes loads in
    the port, whose engine gives the JAX engine's greedy tokens."""
    jp, _ = plans
    path = str(tmp_path / "plan.npz")
    jp.to_policy(backend=backend, block=16).save(path, sp=jp.stacked_sp)
    jpol, jsp = JPolicy.load(path)
    tpol, tsp = SparsityPolicy.load(path, device="cpu")
    assert tpol.to_dict() == {**jpol.to_dict(), "interpret": None}
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, m["jcfg"].vocab_size, n).astype(np.int32)
               for n in (20, 9, 33)]
    jout = _serve(JEngine(m["jparams"], m["jcfg"],
                          JEngineConfig(policy=jpol, **TRACE), jsp), prompts)
    tout = _serve(Engine(m["params"], m["cfg"],
                         EngineConfig(policy=tpol, **TRACE), tsp,
                         device="cpu"), prompts)
    assert tout == jout


def test_port_artifact_loads_in_jax(plans, tmp_path):
    _, tp = plans
    path = str(tmp_path / "plan.npz")
    tpol = tp.to_policy(backend="pallas", sensitive_backend="mask")
    tpol.save(path, sp=tp.stacked_sp)
    jpol, jsp = JPolicy.load(path)
    assert jpol.to_dict() == tpol.to_dict()
    flat_j = tpolicy._flatten_sp(_t(jsp))
    flat_t = tpolicy._flatten_sp(tp.stacked_sp)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_t:
        assert flat_j[k].dtype == flat_t[k].dtype
        assert np.array_equal(flat_j[k], flat_t[k]), k


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_artifact_versions_round_trip(plans, tmp_path, version, monkeypatch):
    _, tp = plans
    path = str(tmp_path / "plan.npz")
    monkeypatch.setattr(tpolicy, "ARTIFACT_VERSION", version)
    SparsityPolicy.uniform("mask").save(path, sp=tp.stacked_sp)
    pol, sp = SparsityPolicy.load(path, device="cpu")
    assert pol == SparsityPolicy.uniform("mask")
    assert tpolicy._flatten_sp(sp).keys() == \
        tpolicy._flatten_sp(tp.stacked_sp).keys()
    SparsityPolicy.dense().save(path)
    pol, sp = SparsityPolicy.load(path)
    assert pol.is_dense and sp is None


def test_artifact_kinds_and_bad_versions_raise(tmp_path, monkeypatch):
    from repro.sparsity import PolicyLadder
    path = str(tmp_path / "x.npz")
    monkeypatch.setattr(tpolicy, "ARTIFACT_VERSION", 5)
    SparsityPolicy.dense().save(path)
    with pytest.raises(ValueError, match="version 5"):
        SparsityPolicy.load(path)
    np.savez(path, a=np.zeros(1))
    with pytest.raises(ValueError, match="not a sparsity artifact"):
        SparsityPolicy.load(path)
    ladder = PolicyLadder(budgets=(0.5,),
                          policies=(JPolicy.uniform("mask"),), sps=(None,))
    ladder.save(path)
    with pytest.raises(ValueError, match="PolicyLadder.load"):
        SparsityPolicy.load(path)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_calib_quick_on_cpu(capsys):
    out = serve.main(["--reduced", "--device", "cpu", "--calib-quick",
                      "--mode", "mask", "--batch", "2", "--prompt-len", "20",
                      "--gen", "3"])
    text = capsys.readouterr().out
    assert "alpha search: block-wise grid (Alg. 2)" in text
    assert "calibrated plan:" in text and "topk_shared" not in text
    assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())


@pytest.mark.parametrize("argv", [
    ["--sensitive-backend", "mask"],
    ["--sensitive-backend", "off", "--sparsity", "0.3"],
    ["--sensitive-backend", "mask", "--calib-quick"]])
def test_sensitive_backend_validation_matches_jax(argv):
    def outcome(mod):
        args = mod.build_parser().parse_args(argv)
        try:
            mod.validate_args(args)
        except SystemExit as e:
            return str(e)
        return None
    assert outcome(serve) == outcome(jserve)
    with pytest.raises(SystemExit, match="drop --calib-quick"):
        serve.validate_args(serve.build_parser().parse_args(
            ["--policy-artifact", "x.npz", "--calib-quick"]))


def test_serve_cli_policy_artifact(plans, tmp_path, capsys):
    _, tp = plans
    path = str(tmp_path / "plan.npz")
    tp.to_policy(backend="pallas").save(path, sp=tp.stacked_sp)
    out = serve.main(["--reduced", "--device", "cpu", "--policy-artifact",
                      path, "--batch", "2", "--prompt-len", "20", "--gen",
                      "3"])
    text = capsys.readouterr().out
    assert f"from {path}" in text and "'backend': 'pallas'" in text
    assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())
