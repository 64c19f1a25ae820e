"""The port's policy ladder against the JAX package: the ladder kind of
the npz artifact in both directions, ``PolicyLadder.uniform``,
``calibrate_ladder`` with its quality baselines, and the baseline
helpers.

Model and data are ``tests/test_torch_calibration.py``'s: the reduced
llama31_8b initialised by JAX with the weight-column spike of
``tests/test_pipeline.py``, carried across by ``models/params.from_numpy``,
and ``SyntheticLM(DataConfig(V, 48, 2, seed=4)).batch(0)`` (the seed
whose searches do not branch apart on a near-tie; see that file's
docstring).  Both packages calibrate a ``pallas`` ladder at budgets
(0.0, 0.3, 0.5) with the ``--calib-quick`` budget (1 generation of 2
offspring).

Tolerances, each with its reason:

- artifacts, uniform ladders, block ratios, alphas, policies, channel
  sets: equal (the same numpy arithmetic, or copies of the same bits);
- taus rtol 1e-5 (``tests/test_torch_calibration.py``'s for
  ``run_pipeline``): each is one calibration score, and the captured
  activations agree to 1e-5, not bitwise;
- baselines' recon rtol 1e-4 (``test_fitness_and_block_mse_match``'s),
  on the same sp trees made tie-free as ``tests/test_torch_calibration.py``
  makes them: each finite tau moved halfway down to the next lower
  calibration score.  A calibrated tau is itself one calibration score,
  and whether ``mask`` keeps that element hangs on its last bit (ROADMAP
  Queue 3, reference behaviour 4): on the ladders' own sp trees one such
  flip moves a block error here by 4.8e-4 relative, so those are held at
  rtol 1e-2 (the flips seen so far moved one by up to 0.6%).  The dense
  rung's error is exactly 0 in the port and about 1e-17 in JAX, hence
  atol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import allocation as JA
from repro.core import calibration as JC
from repro.core import unstacked as JU
from repro.models import api as japi
from repro.obs import quality as JQ
from repro.sparsity import PolicyLadder as JLadder
from repro.sparsity import SparsityPolicy as JPolicy
from repro.sparsity import calibrate_ladder as jcalibrate_ladder
from repro.sparsity import ladder as jladder_mod
from repro_torch.configs import get_config, reduced
from repro_torch.core import allocation as TA
from repro_torch.core import calibration as TC
from repro_torch.core import unstacked as TU
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import params as P
from repro_torch.obs import quality as TQ
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from repro_torch.sparsity import calibrate_ladder
from repro_torch.sparsity import ladder as tladder_mod
from repro_torch.sparsity import policy as tpolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

DATA_SEED = 4
BUDGETS = (0.0, 0.3, 0.5)
QUICK = dict(delta=0.25, coord_passes=0)     # the serve CLI's --calib-quick
EVO = dict(generations=1, offspring=2, eps=0.1)


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def m():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = jax.tree_util.tree_map_with_path(_spike,
                                               japi.init_model(jcfg, 0))
    toks = SyntheticLM(DataConfig(jcfg.vocab_size, 48, 2,
                                  seed=DATA_SEED)).batch(0)
    cfg = reduced(get_config("llama31_8b"))
    params = P.from_numpy(_np(jparams))
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                toks=toks,
                jctx=JC.build_context(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks)}),
                tctx=TC.build_context(params, cfg, {"tokens": toks}))


@pytest.fixture(scope="module")
def ladders(m):
    jl = jcalibrate_ladder(m["jparams"], m["jcfg"], None, BUDGETS,
                           backend="pallas", evo=JA.EvoConfig(**EVO),
                           ctx=m["jctx"], **QUICK)
    tl = calibrate_ladder(m["params"], m["cfg"], None, BUDGETS,
                          backend="pallas", evo=TA.EvoConfig(**EVO),
                          ctx=m["tctx"], **QUICK)
    return jl, tl


def _leaf_values(sp, cfg, key):
    """{(depth, path): value of the scalar sp leaf ``key``}."""
    out = {}
    for d, spd in enumerate(TQ.unstack_sp(cfg, sp)):
        for path in _paths(spd):
            out[(d, path)] = float(TU.get_sp_leaf(spd, path)[key])
    return out


def _paths(node, prefix=""):
    for k in sorted(node):
        if isinstance(node[k], dict) and "g" in node[k]:
            yield prefix + k
        elif isinstance(node[k], dict):
            yield from _paths(node[k], prefix + k + "/")


def _assert_same_ladder(got, want, g_rtol=None):
    """Two ladders (either package) with equal budgets, policy dicts,
    block ratios, sp leaves and baselines; with ``g_rtol``, the column
    norms ``g`` within it (each package computed its own: f32 sums in
    another order)."""
    assert tuple(got.budgets) == tuple(want.budgets)
    assert [p.to_dict() for p in got.policies] == \
        [{**p.to_dict(), "interpret": None} for p in want.policies]
    if want.block_ratios is None:
        assert got.block_ratios is None
    else:
        for a, b in zip(got.block_ratios, want.block_ratios):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(got.sps, want.sps):
        fa, fb = tpolicy._flatten_sp(_as_torch(a)), \
            tpolicy._flatten_sp(_as_torch(b))
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            if g_rtol is not None and k.endswith("/g"):
                np.testing.assert_allclose(fa[k], fb[k], rtol=g_rtol)
            else:
                assert np.array_equal(fa[k], fb[k]), k
    if want.baselines is None:
        assert got.baselines is None
    else:
        assert np.array_equal(got.baselines["recon"], want.baselines["recon"])
        for ra, rb in zip(got.baselines["channels"],
                          want.baselines["channels"]):
            assert all(np.array_equal(a, b) for a, b in zip(ra, rb))


def _as_torch(sp):
    """An sp tree of either package as torch tensors."""
    return sp if sp is None or _is_torch(sp) else P.from_numpy(_np(sp))


def _is_torch(tree):
    if isinstance(tree, dict):
        return all(_is_torch(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_is_torch(v) for v in tree)
    return isinstance(tree, torch.Tensor)


# ---------------------------------------------------------------------------
# calibrate_ladder
# ---------------------------------------------------------------------------

def test_calibrate_ladder_matches(m, ladders):
    jl, tl = ladders
    cfg = m["cfg"]
    assert tl.budgets == jl.budgets == BUDGETS
    for a, b in zip(tl.block_ratios, jl.block_ratios):
        assert np.array_equal(a, b)
    assert any(not np.all(r == b)                   # a search moved
               for r, b in zip(tl.block_ratios[1:], BUDGETS[1:]))
    assert [p.to_dict() for p in tl.policies] == \
        [{**p.to_dict(), "interpret": None} for p in jl.policies]
    assert tl.policies[0].is_dense
    for r, (tsp, jsp) in enumerate(zip(tl.sps, jl.sps)):
        jt = P.from_numpy(_np(jsp))
        for key in ("alpha", "keep_frac"):
            assert _leaf_values(tsp, cfg, key) == \
                _leaf_values(jt, cfg, key), (r, key)
        tt, jtau = _leaf_values(tsp, cfg, "tau"), _leaf_values(jt, cfg, "tau")
        assert tt.keys() == jtau.keys()
        for k, t in jtau.items():
            if np.isfinite(t):
                np.testing.assert_allclose(tt[k], t, rtol=1e-5)
            else:
                assert tt[k] == t
        # g is a property of the weights: one array shared by every rung
        for a, b in zip(tpolicy._flatten_sp(tsp).items(),
                        tpolicy._flatten_sp(tl.sps[0]).items()):
            if a[0].endswith("/g"):
                assert np.array_equal(a[1], b[1])
    np.testing.assert_allclose(tl.baselines["recon"], jl.baselines["recon"],
                               rtol=1e-2, atol=1e-12)
    assert np.all(tl.baselines["recon"][0] == 0.0)    # the dense rung
    for ra, rb in zip(tl.baselines["channels"], jl.baselines["channels"]):
        assert len(ra) == len(rb) == m["cfg"].num_layers
        for a, b in zip(ra, rb):
            assert np.array_equal(a, b)


def _tie_free(m, sp):
    """JAX sp tree with each finite tau moved halfway down to the next
    lower calibration score (see the module docstring)."""
    jctx, jcfg = m["jctx"], m["jcfg"]
    per = [jax.tree_util.tree_map(lambda a: a, d)
           for d in JQ.unstack_sp(jcfg, sp)]
    for d, spd in enumerate(per):
        for path in jctx.keys_by_depth[d]:
            leaf = JU.get_sp_leaf(spd, path)
            tau = float(leaf["tau"])
            if np.isfinite(tau):
                s = jctx.scores_for((d, path), float(leaf["alpha"]))
                i = int(np.searchsorted(s, np.float32(tau)))
                low = float(s[i - 1]) if i > 0 else 0.0
                JU.set_sp_leaf(spd, path, "tau", 0.5 * (low + tau))
    return JU.restack_sp(jcfg, per)


def test_quality_baselines_match_on_tie_free_sp(m, ladders):
    jl, _ = ladders
    sps = [_tie_free(m, sp) for sp in jl.sps]
    want = jladder_mod._quality_baselines(m["jcfg"], m["jctx"], sps, 32)
    got = tladder_mod._quality_baselines(
        m["cfg"], m["tctx"], [P.from_numpy(_np(sp)) for sp in sps], 32)
    np.testing.assert_allclose(got["recon"], want["recon"], rtol=1e-4,
                               atol=1e-12)
    assert np.all(got["recon"][1:] > 0)
    for ra, rb in zip(got["channels"], want["channels"]):
        assert all(np.array_equal(a, b) for a, b in zip(ra, rb))


def test_ladder_is_monotone_per_block(ladders):
    _, tl = ladders
    for lo, hi in zip(tl.block_ratios, tl.block_ratios[1:]):
        assert np.all(hi >= lo - 1e-9)


def test_calibrate_ladder_validation(m):
    with pytest.raises(ValueError, match="budgets"):
        calibrate_ladder(m["params"], m["cfg"], None, (0.0, 1.0),
                         ctx=m["tctx"])


# ---------------------------------------------------------------------------
# the artifact, across the two packages
# ---------------------------------------------------------------------------

def test_jax_ladder_artifact_loads_in_the_port(ladders, tmp_path):
    jl, _ = ladders
    path = str(tmp_path / "ladder.npz")
    jl.save(path)
    tl = PolicyLadder.load(path, device="cpu")
    _assert_same_ladder(tl, jl)
    assert tl.baselines is not None


def test_port_ladder_artifact_loads_in_jax(ladders, tmp_path):
    _, tl = ladders
    path = str(tmp_path / "ladder.npz")
    tl.save(path)
    jl = JLadder.load(path)
    _assert_same_ladder(tl, jl)
    back = PolicyLadder.load(path)
    _assert_same_ladder(back, tl)


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_older_ladder_artifacts_read_in_both(m, tmp_path, monkeypatch,
                                             version, writer):
    """A pre-v4 ladder (no quality baselines) written by either package
    reads in both."""
    path = str(tmp_path / "ladder.npz")
    jl = JLadder.uniform(m["jparams"], m["jcfg"], budgets=(0.0, 0.5),
                         backend="topk_block", block=16)
    if writer == "jax":
        monkeypatch.setattr(jladder_mod, "ARTIFACT_VERSION", version)
        jl.save(path)
    else:
        monkeypatch.setattr(tladder_mod, "ARTIFACT_VERSION", version)
        PolicyLadder.uniform(m["params"], m["cfg"], budgets=(0.0, 0.5),
                             backend="topk_block", block=16).save(path)
    import json
    meta = json.loads(str(np.load(path)["__meta__"][()]))
    assert meta["version"] == version and meta["kind"] == "ladder"
    tl = PolicyLadder.load(path)
    _assert_same_ladder(tl, JLadder.load(path))
    _assert_same_ladder(tl, jl, g_rtol=None if writer == "jax" else 1e-6)


def test_artifact_kinds_are_gated(ladders, tmp_path):
    jl, tl = ladders
    path = str(tmp_path / "x.npz")
    tl.save(path)
    with pytest.raises(ValueError, match="PolicyLadder.load"):
        SparsityPolicy.load(path)
    SparsityPolicy.dense().save(path)
    with pytest.raises(ValueError, match="SparsityPolicy.load"):
        PolicyLadder.load(path)


def test_ladder_sp_lands_on_the_asked_device(ladders, tmp_path):
    _, tl = ladders
    path = str(tmp_path / "ladder.npz")
    tl.save(path)
    got = PolicyLadder.load(path, device=torch.device("cpu"))
    leaf = got.sps[1][0]["l0"]["attn"]["wq"]
    assert leaf["tau"].device.type == "cpu" and leaf["g"].dtype == \
        torch.float32


def test_ladder_rungs_must_share_one_sp_schema(m, ladders, tmp_path):
    _, tl = ladders
    sp1 = [{"l0": {"attn": dict(tl.sps[1][0]["l0"]["attn"])}}]
    bad = PolicyLadder(budgets=(0.0, 0.5), policies=tl.policies[:2],
                       sps=(tl.sps[0], sp1))
    with pytest.raises(ValueError, match="one sp schema"):
        bad.save(str(tmp_path / "bad.npz"))


# ---------------------------------------------------------------------------
# uniform ladders, validation, the baseline helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,budgets", [
    ("topk_shared", (0.0, 0.5, 0.7)), ("pallas", (0.2, 0.6))])
def test_uniform_ladder_leaves_equal(m, backend, budgets):
    jl = JLadder.uniform(m["jparams"], m["jcfg"], budgets=budgets,
                         backend=backend)
    tl = PolicyLadder.uniform(m["params"], m["cfg"], budgets=budgets,
                              backend=backend)
    assert [p.to_dict() for p in tl.policies] == \
        [{**p.to_dict(), "interpret": None} for p in jl.policies]
    for a, b in zip(tl.sps, jl.sps):
        fa = tpolicy._flatten_sp(a)
        fb = tpolicy._flatten_sp(P.from_numpy(_np(b)))
        assert fa.keys() == fb.keys()
        for k in fa:
            if k.endswith("/g"):     # column norms: f32 sums in other order
                np.testing.assert_allclose(fa[k], fb[k], rtol=1e-6)
            else:
                assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("kw,err,match", [
    (dict(budgets=(), policies=(), sps=()), ValueError, "at least one"),
    (dict(budgets=(0.0, 0.5), policies=(SparsityPolicy.dense(),),
          sps=(None, None)), ValueError, "mismatch"),
    (dict(budgets=(0.5, 0.5), policies=(SparsityPolicy.dense(),) * 2,
          sps=(None, None)), ValueError, "ascending"),
    (dict(budgets=(0.5,), policies=("off",), sps=(None,)), TypeError,
     "SparsityPolicy")])
def test_ladder_validation_matches_jax(kw, err, match):
    with pytest.raises(err, match=match):
        PolicyLadder(**kw)
    jkw = dict(kw, policies=tuple(
        JPolicy.dense() if isinstance(p, SparsityPolicy) else p
        for p in kw["policies"]))
    with pytest.raises(err, match=match):
        JLadder(**jkw)


def test_ladder_rung_and_len(ladders):
    _, tl = ladders
    assert len(tl) == 3
    pol, sp = tl.rung(2)
    assert pol is tl.policies[2] and sp is tl.sps[2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_baseline_helpers_match(m, ladders, seed):
    """``saliency_channels`` on the same numpy inputs, and
    ``rep_saliency_leaf``/``unstack_sp`` on the same sp tree."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal(64)).astype(np.float32)
    g = (np.abs(rng.standard_normal(64)) + 0.1).astype(np.float32)
    for alpha, k in ((0.0, 8), (0.7, 32), (1.5, 100)):
        assert np.array_equal(TQ.saliency_channels(x, g, alpha, k),
                              JQ.saliency_channels(x, g, alpha, k))
    jl, _ = ladders
    jsp = jl.sps[1 + seed % 2]
    jper = JQ.unstack_sp(m["jcfg"], jsp)
    tper = TQ.unstack_sp(m["cfg"], P.from_numpy(_np(jsp)))
    assert len(tper) == len(jper)
    for td, jd in zip(tper, jper):
        tg, ta = TQ.rep_saliency_leaf(td, m["cfg"].d_model)
        jg, ja = JQ.rep_saliency_leaf(_np(jd), m["jcfg"].d_model)
        assert np.array_equal(tg, jg) and ta == ja
    assert TQ.rep_saliency_leaf({"mlp": {"wo": {"g": torch.ones(3),
                                                 "alpha": 0.0}}}, 64) is None
