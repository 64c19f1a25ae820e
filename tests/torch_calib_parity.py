"""Shared checks of the port's WiSparse calibration (paper Alg. 1-4) over
MoE, SSM and hybrid layers against the JAX package, used by
``tests/test_torch_calibration_moe.py`` (reduced granite_moe_1b_a400m),
``tests/test_torch_calibration_ssm.py`` (reduced mamba2_130m) and
``tests/test_torch_calibration_jamba.py`` (reduced jamba_v01_52b).

Weights are initialised by JAX (seed 0) and carried across with
``models/params.from_numpy``.  The reduced granite's attention, router
and expert weights are scaled by ``chip_smoke.GEMMA_WEIGHT_SCALE`` on
both sides (``tests/test_torch_moe_engine.py``'s reason: at the init its
tied head emits the last prompt token forever).  Calibration tokens: 2
x 32 from ``np.random.default_rng(0)``; the search runs the serve CLI's
``--calib-quick`` stages (``delta`` 0.25, no coordinate passes) at one
generation of two offspring.  The two packages' searches compare block
errors that agree to about 1e-6, not bitwise, so a near-tie can branch
them apart: on ``SyntheticLM(DataConfig(V, 32, 2, seed=0)).batch(0)``
jamba's alpha grid picks 1.1 in the port and 1.05 in JAX at depth 2
(ROADMAP, reference behaviour 4); these tokens have no such near-tie.

Tolerances, each with its reason:

- keys, sizes, search outputs (block and layer ratios, alphas),
  policies, artifacts and greedy tokens: equal (the same numpy
  arithmetic, or copies of the same bits);
- captured activations, column norms, block inputs and outputs, dense
  logits: 1e-5 (f32 sums in another order);
- ``tau_for`` on identical numpy activations: rtol 1e-6 (``pow`` may
  differ by an ulp between numpy and torch);
- ``block_mse`` and ``fitness`` on one sp list, made tie-free first
  (:func:`tie_free_sp`), since whether ``mask`` keeps an element that
  sits on its tau hangs on its last bit: ``block_mse`` rtol 1e-5;
  ``fitness`` rtol 1e-4 (``tests/test_torch_calibration.py``'s).  The
  KL is a sum of products of probabilities and log-probability
  differences, about 5e-3 here, so logits that agree to 1e-6 move it by
  1e-5 to 1.5e-5 relative on jamba's 8 layers, with no mask decision
  flipped (every block error there agrees within 1.3e-6);
- calibrated taus: rtol 1e-2, atol 1e-12.  Each is one calibration
  score of activations that agree to 1e-5, not bitwise (ROADMAP,
  reference behaviour 4).
"""
import dataclasses
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import allocation as JA
from repro.core import calibration as JC
from repro.core import pipeline as JP
from repro.core import unstacked as JU
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.sparsity import PolicyLadder as JLadder
from repro.sparsity import SparsityPolicy as JPolicy
from repro.sparsity import calibrate_ladder as jcalibrate_ladder
from repro_torch.configs import get_config, reduced
from repro_torch.core import allocation as TA
from repro_torch.core import calibration as TC
from repro_torch.core import pipeline as TP
from repro_torch.core import unstacked as TU
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig
from repro_torch.sparsity import (PolicyLadder, SparsityPolicy,
                                  calibrate_ladder)
from repro_torch.sparsity import policy as tpolicy

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 1e-5
FIT_RTOL = 1e-4
DATA_SEED = 0
QUICK = dict(delta=0.25, coord_passes=0)     # the serve CLI's --calib-quick
EVO = dict(generations=1, offspring=2, eps=0.1)
# (alpha, keep ratio) pairs at which tau_for is compared, per key
TAU_PAIRS = ((0.0, 0.5), (0.7, 0.25), (1.5, 0.9))
# the engine trace: prompts of 20, 9 and 33 tokens, 8 new tokens each
TRACE = dict(max_slots=4, max_len=64, prefill_chunk=16)
PROMPT_LENS = (20, 9, 33)
GEN = 8
BLOCK = 16
SCALED = ("granite_moe_1b_a400m",)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(sp):
    """{"0/l0/attn/wq/g": ndarray, ...} of a stacked sp tree of either
    package."""
    return tpolicy._flatten_sp(jax.tree_util.tree_map(np.array, sp))


def _scaled(jparams):
    """Attention, router and expert weights times GEMMA_WEIGHT_SCALE."""
    def f(path, a):
        keys = [getattr(p, "key", None) for p in path]
        return a * chip_smoke.GEMMA_WEIGHT_SCALE \
            if ("attn" in keys or "moe" in keys) else a
    return jax.tree_util.tree_map_with_path(f, jparams)


class _Model(dict):
    """One arch's models in both packages; the calibration contexts
    (``jctx``, ``tctx``) and ``--calib-quick``-stage plans at budget 0.5
    (``jplan``, ``tplan``) are made on first use, so a test that needs
    one package's plan only builds that package's context."""

    def __missing__(self, key):
        if key == "jctx":
            val = JC.build_context(self["jparams"], self["jcfg"],
                                   {"tokens": jnp.asarray(self["toks"])})
        elif key == "tctx":
            val = TC.build_context(self["params"], self["cfg"],
                                   {"tokens": self["toks"]})
        elif key == "jplan":
            val = JP.run_pipeline(self["jparams"], self["jcfg"], None, 0.5,
                                  evo=JA.EvoConfig(**EVO), ctx=self["jctx"],
                                  **QUICK)
        elif key == "tplan":
            val = TP.run_pipeline(self["params"], self["cfg"], None, 0.5,
                                  evo=TA.EvoConfig(**EVO), ctx=self["tctx"],
                                  **QUICK)
        else:
            raise KeyError(key)
        self[key] = val
        return val


_MODELS = {}


def model(arch):
    """Both packages' reduced model and calibration tokens."""
    if arch not in _MODELS:
        jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
        jparams = japi.init_model(jcfg, 0)
        if arch in SCALED:
            jparams = _scaled(jparams)
        toks = np.random.default_rng(DATA_SEED).integers(
            0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        _MODELS[arch] = _Model(
            arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams,
            params=P.from_numpy(_np(jparams)), toks=toks)
    return _MODELS[arch]


def _seen_scores(m, tsp):
    """{key: the Eq. 4 scores of every input that key's ``mask``
    projection sees in the port's ``fitness`` and ``block_mse`` runs
    under the per-depth sp list ``tsp``} (f64 numpy)."""
    from repro_torch.core import sparse_linear as sl
    tctx = m["tctx"]
    owner = {id(TU.get_sp_leaf(spd, path)["tau"]): (d, path)
             for d, spd in enumerate(tsp)
             for path in tctx.keys_by_depth[d]}
    seen, real = {}, sl._dispatch

    def recording(x, w, sp, policy, role, **kw):
        key = None if sp is None else owner.get(id(sp["tau"]))
        if key is not None:
            g = sp["g"][:, None, :] if kw.get("experts") else sp["g"]
            seen.setdefault(key, []).append(
                sl.scores(x, g, sp["alpha"]).reshape(-1).double().numpy())
        return real(x, w, sp, policy, role, **kw)

    sl._dispatch = recording
    try:
        tctx.fitness(tsp)
        for d in range(tctx.num_blocks):
            tctx.block_mse(d, tsp[d])
    finally:
        sl._dispatch = real
    return {k: np.concatenate(v) for k, v in seen.items()}


def tie_free_sp(m, alphas, ratios, window: int = 8, rounds: int = 4):
    """JAX's make_sp with each finite tau moved to the middle of the
    widest gap between the scores next to it (``window`` on each side):
    the calibration scores, and the scores of the inputs each projection
    sees when the sparse block and model run (a MoE's ``wo`` input, for
    one, comes after the sparse ``wi_gate``/``wi_up`` and is no
    calibration activation).  Moving a tau moves what later projections
    see, so this repeats until no seen score lies within 1e-5 (relative)
    of its tau, at most ``rounds`` times."""
    jctx = m["jctx"]
    jsp = jctx.make_sp(alphas, ratios)
    for _ in range(rounds):
        tsp = [P.from_numpy(_np(s)) for s in jsp]
        seen = _seen_scores(m, tsp)
        close = False
        for d, spd in enumerate(jsp):
            for path in jctx.keys_by_depth[d]:
                key = (d, path)
                tau = float(JU.get_sp_leaf(spd, path)["tau"])
                if not np.isfinite(tau):
                    continue
                mine = seen.get(key, np.zeros(0))
                close |= bool(np.any(np.abs(mine - tau) <= 1e-5 * abs(tau)))
                s = np.unique(np.concatenate(
                    [jctx.scores_for(key, alphas[key]).astype(np.float64),
                     mine]))
                i = int(np.searchsorted(s, tau))
                lo, hi = max(i - window, 0), min(i + window, len(s) - 1)
                gaps = np.diff(s[lo:hi + 1])
                j = lo + int(np.argmax(gaps))
                JU.set_sp_leaf(spd, path, "tau", 0.5 * (s[j] + s[j + 1]))
        if not close:
            return jsp
    raise AssertionError(f"no tie-free sp list in {rounds} rounds")


def expert_keys(ctx):
    return [k for k, g in ctx.g.items() if np.asarray(g).ndim == 2]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def check_build_context(m):
    """keys_by_depth, g ((E, n) for an expert key), sizes (top-k scaled),
    acts ((E, T, n) for an expert key), dense logits and block io."""
    jctx, tctx = m["jctx"], m["tctx"]
    assert tctx.keys_by_depth == jctx.keys_by_depth
    assert tctx.sizes == jctx.sizes
    assert list(tctx.acts) == list(jctx.acts)
    assert list(tctx.g) == list(jctx.g) and set(jctx.g) == set(jctx.acts)
    for k in jctx.acts:
        assert tuple(tctx.acts[k].shape) == jctx.acts[k].shape, k
        assert tuple(tctx.g[k].shape) == jctx.g[k].shape, k
        np.testing.assert_allclose(tctx.acts[k].numpy(), jctx.acts[k],
                                   rtol=TOL, atol=TOL, err_msg=str(k))
        np.testing.assert_allclose(tctx.g[k].numpy(), jctx.g[k], rtol=TOL,
                                   atol=TOL, err_msg=str(k))
    assert len(tctx.block_io) == len(jctx.block_io) == tctx.num_blocks + 1
    for a, b in zip(tctx.block_io, jctx.block_io):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(tctx.dense_logits.numpy(),
                               np.asarray(jctx.dense_logits), rtol=TOL,
                               atol=TOL)
    for d in range(tctx.num_blocks):
        assert tctx.block_weight(d) == jctx.block_weight(d)


def check_tau_for(m):
    """Both packages' tau_for on the same numpy activations and g."""
    jctx = m["jctx"]
    tctx = dataclasses.replace(
        m["tctx"],
        acts={k: torch.from_numpy(v) for k, v in jctx.acts.items()},
        g={k: torch.from_numpy(np.array(v)) for k, v in jctx.g.items()},
        _tau_cache={})
    for key in jctx.acts:
        for alpha, keep in TAU_PAIRS:
            np.testing.assert_allclose(tctx.tau_for(key, alpha, keep),
                                       jctx.tau_for(key, alpha, keep),
                                       rtol=1e-6, err_msg=str(key))
        assert tctx.tau_for(key, 0.5, 1.0) == jctx.tau_for(key, 0.5, 1.0) \
            == -np.inf


def check_evaluators(m, seed: int = 0):
    """block_mse of every block and fitness on one tie-free sp list."""
    jctx, tctx = m["jctx"], m["tctx"]
    rng = np.random.default_rng(seed)
    keys = list(jctx.acts)
    ratios = {k: float(rng.choice([0.25, 0.5, 0.75, 1.0])) for k in keys}
    alphas = {k: float(rng.choice([0.0, 0.5, 1.0, 1.5])) for k in keys}
    jsp = tie_free_sp(m, alphas, ratios)
    tsp = [P.from_numpy(_np(s)) for s in jsp]
    np.testing.assert_allclose(tctx.fitness(tsp), jctx.fitness(jsp),
                               rtol=FIT_RTOL)
    for d in range(jctx.num_blocks):
        np.testing.assert_allclose(tctx.block_mse(d, tsp[d]),
                                   jctx.block_mse(d, jsp[d]), rtol=TOL)


def assert_taus_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, t in want.items():
        if np.isfinite(t):
            np.testing.assert_allclose(got[k], t, rtol=1e-2, atol=1e-12,
                                       err_msg=str(k))
        else:
            assert got[k] == t, k


def check_pipeline(m):
    jp, tp = m["jplan"], m["tplan"]
    assert np.array_equal(tp.block_ratios, jp.block_ratios)
    assert tp.layer_ratios == jp.layer_ratios
    assert tp.alphas == jp.alphas
    assert_taus_close(tp.taus, jp.taus)
    assert tp.summary() == jp.summary()
    # the stacked sp tree the serving model takes: the JAX plan's, leaf
    # for leaf (g and the searched scalars), taus as above
    flat_j = flat(jp.stacked_sp)
    flat_t = flat(tp.stacked_sp)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_t:
        assert flat_t[k].shape == flat_j[k].shape, k
        rtol = 1e-2 if k.endswith("/tau") else TOL
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=rtol,
                                   atol=1e-12, err_msg=k)


def check_policy(m):
    """``from_plan`` (``k_max_frac`` the plan's largest layer keep ratio)
    and the sensitive-block backend on every (depth, role) of the arch."""
    jp, tp = m["jplan"], m["tplan"]
    for kw in (dict(backend="pallas"),
               dict(backend="pallas", sensitive_backend="mask",
                    sensitive_frac=0.5)):
        jpol, tpol = jp.to_policy(**kw), tp.to_policy(**kw)
        assert tpol.to_dict() == {**jpol.to_dict(), "interpret": None}
        for d, paths in m["tctx"].keys_by_depth.items():
            for path in paths:
                assert tpol.resolve_depth(d).backend_at(role=path) == \
                    jpol.resolve_depth(d).backend_at(role=path), (d, path)
    keep = 1.0 - min(jp.layer_ratios.values())
    assert tp.to_policy().k_max_frac == jp.to_policy().k_max_frac == keep


def _prompts(m, lens):
    rng = np.random.default_rng(1)
    return [rng.integers(0, m["jcfg"].vocab_size, n).astype(np.int32)
            for n in lens]


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p, GEN)
    return engine.run()


def serve_both(m, path, lens=PROMPT_LENS):
    """Greedy tokens of the JAX and the port engine, each serving the npz
    policy artifact at ``path`` loaded by its own package, on prompts of
    ``lens`` tokens."""
    jpol, jsp = JPolicy.load(path)
    tpol, tsp = SparsityPolicy.load(path, device="cpu")
    assert tpol.to_dict() == {**jpol.to_dict(), "interpret": None}
    prompts = _prompts(m, lens)
    jout = _serve(JEngine(m["jparams"], m["jcfg"],
                          JEngineConfig(policy=jpol, **TRACE), jsp), prompts)
    tout = _serve(Engine(m["params"], m["cfg"],
                         EngineConfig(policy=tpol, **TRACE), tsp,
                         device="cpu"), prompts)
    return jout, tout, jsp, tsp


def check_artifact_tokens(m, backend, calibrated_by, tmp_path,
                          lens=PROMPT_LENS):
    """A plan calibrated by ``calibrated_by`` ("jax" or "port") ships as
    the npz artifact; the other package loads it bit for bit and both
    engines give the same greedy tokens."""
    plan = m["jplan"] if calibrated_by == "jax" else m["tplan"]
    path = str(tmp_path / "plan.npz")
    plan.to_policy(backend=backend, block=BLOCK).save(path,
                                                      sp=plan.stacked_sp)
    jout, tout, jsp, tsp = serve_both(m, path, lens)
    assert tout == jout
    assert all(len(t) == GEN for t in tout.values())
    flat_j = flat(jsp)
    flat_t = flat(tsp)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_t:
        assert flat_j[k].dtype == flat_t[k].dtype
        assert np.array_equal(flat_j[k], flat_t[k]), k
    return tout


def ladders(m):
    """A (0.0, 0.5) ``pallas`` ladder from each package on the same
    contexts.  The JAX ladder's one search, the cold rung at 0.5, is
    ``run_pipeline`` at the arguments of ``m["jplan"]`` on the same
    context, so that plan stands in for it (the search is deterministic;
    the JAX ladder still builds its dense rung, policies, block ratios
    and quality baselines itself)."""
    if "ladders" not in m:
        def cold_rung(params, cfg, batch, p_target, **kw):
            assert p_target == 0.5 and kw["warm_start"] is None
            return m["jplan"]

        kw = dict(backend="pallas", **QUICK)
        with mock.patch.object(JP, "run_pipeline", cold_rung):
            jl = jcalibrate_ladder(m["jparams"], m["jcfg"], None, (0.0, 0.5),
                                   evo=JA.EvoConfig(**EVO), ctx=m["jctx"],
                                   **kw)
        tl = calibrate_ladder(m["params"], m["cfg"], None, (0.0, 0.5),
                              evo=TA.EvoConfig(**EVO), ctx=m["tctx"], **kw)
        m["ladders"] = (jl, tl)
    return m["ladders"]


def check_calibrate_ladder(m, tmp_path):
    """Budgets, policies and block ratios equal; each rung's sp leaves as
    the JAX ladder's (taus rtol 1e-2); recon baselines rtol 1e-2 (each
    block error hangs on calibrated taus), saliency channels equal.
    Each package's ladder artifact loads in the other bit for bit."""
    jl, tl = ladders(m)
    for ladder, load in ((tl, JLadder.load), (jl, PolicyLadder.load)):
        path = str(tmp_path / "ladder.npz")
        ladder.save(path)
        for a, b in zip(ladder.sps, load(path).sps):
            fa, fb = flat(a), flat(b)
            assert fa.keys() == fb.keys()
            assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert tuple(tl.budgets) == tuple(jl.budgets)
    assert [p.to_dict() for p in tl.policies] == \
        [{**p.to_dict(), "interpret": None} for p in jl.policies]
    for a, b in zip(tl.block_ratios, jl.block_ratios):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for tsp, jsp in zip(tl.sps, jl.sps):
        flat_j = flat(jsp)
        flat_t = flat(tsp)
        assert flat_j.keys() == flat_t.keys()
        for k in flat_t:
            rtol = 1e-2 if k.endswith("/tau") else TOL
            np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=rtol,
                                       atol=1e-12, err_msg=k)
    np.testing.assert_allclose(tl.baselines["recon"], jl.baselines["recon"],
                               rtol=1e-2, atol=1e-12)
    for ra, rb in zip(tl.baselines["channels"], jl.baselines["channels"]):
        for a, b in zip(ra, rb):
            assert np.array_equal(a, b)


def check_artifact_versions(m, tmp_path):
    """The port's plan as a policy artifact of every readable version
    (1-4) and back, its expert or mamba leaves bit for bit, in both
    packages."""
    import pytest
    tp = m["tplan"]
    want = flat(tp.stacked_sp)
    for version in (1, 2, 3, 4):
        path = str(tmp_path / f"v{version}.npz")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpolicy, "ARTIFACT_VERSION", version)
            tp.to_policy(backend="pallas").save(path, sp=tp.stacked_sp)
        for load in (lambda p: SparsityPolicy.load(p, device="cpu"),
                     JPolicy.load):
            pol, sp = load(path)
            assert pol.k_max_frac == tp.to_policy().k_max_frac
            got = flat(sp)
            assert got.keys() == want.keys()
            assert all(np.array_equal(got[k], want[k]) for k in want)
