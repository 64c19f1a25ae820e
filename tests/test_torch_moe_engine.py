"""The port's engine on MoE and deepseek models against the JAX engine,
the step costs of MoE layers, and the serve CLI on the granites.

Reduced granite_moe_1b_a400m and granite_moe_3b_a800m (f32, 4 experts,
top-2) have their attention, router and expert weights scaled by
``chip_smoke.GEMMA_WEIGHT_SCALE`` on both sides: at the init a reduced
granite, whose head is tied to its embedding, emits its last prompt
token forever, which no token comparison could tell apart.  Reduced
deepseek_67b (a dense llama layout) runs at its init.  Weights are
initialised by JAX and carried across by ``models/params.from_numpy``.

The engine trace: 4 slots, ``max_len`` 64, chunks of 16, prompts of 20,
9 and 33 tokens (partial last chunks, the last one's pad rows routed as
the reference routes them), 8 new tokens each; one slot stays free.
Greedy tokens are compared for exact equality; logits at 1e-5.
Sparse backends run with ``block=16``, ``k_max_frac=0.5`` and an sp
tree at ``keep_frac=0.5``.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import api as japi
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.kernels import sparse_matmul as K
from repro_torch.launch import serve
from repro_torch.launch.roofline import step_costs
from repro_torch.models import api
from repro_torch.models import model as TM
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig, graphs
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 1e-5
SCALE = chip_smoke.GEMMA_WEIGHT_SCALE
GRANITES = ["granite_moe_1b_a400m", "granite_moe_3b_a800m"]
TRACE = dict(max_slots=4, max_len=64, prefill_chunk=16)
PROMPT_LENS = (20, 9, 33)
GEN = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled(jparams):
    def f(path, a):
        keys = [getattr(p, "key", None) for p in path]
        return a * SCALE if ("attn" in keys or "moe" in keys) else a
    return jax.tree_util.tree_map_with_path(f, jparams)


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
        if cfg.family == "moe":
            jparams = _scaled(jparams)
        jsp = jdefault_sp(jparams, jcfg, keep_frac=0.5)
        _MODELS[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jsp=jsp,
                             params=P.from_numpy(_np(jparams)))
    return _MODELS[arch]


def _policies(backend):
    kw = dict(k_max_frac=0.5, block=16)
    return (JPolicy.uniform(backend, interpret=True, **kw),
            SparsityPolicy.uniform(backend, **kw))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def _run(eng, prompts, gen=GEN):
    for p in prompts:
        eng.submit(p, gen)
    return eng.run()


# uncalibrated pallas serves at tau -inf (the reference's +inf zeroes
# every projection); mask thresholds at a finite tau
TAUS = {"off": None, "mask": 0.05, "pallas": -np.inf}


def _engines(arch, backend):
    m = _model(arch)
    tau = TAUS[backend]
    jsp = None if tau is None else _with_tau(m["jsp"], tau)
    jpol, tpol = _policies(backend)
    jeng = JEngine(m["jparams"], m["jcfg"], JEngineConfig(policy=jpol,
                                                         **TRACE), jsp)
    teng = Engine(m["params"], m["cfg"], EngineConfig(policy=tpol, **TRACE),
                  None if jsp is None else P.from_numpy(_np(jsp)),
                  device="cpu")
    return jeng, teng


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
@pytest.mark.parametrize("arch", GRANITES + ["deepseek_67b"])
def test_engine_tokens_equal_jax(arch, backend):
    """Chunked prefill with partial last chunks, then batched decode with
    a free slot: exactly the JAX engine's greedy tokens.  The granites
    resolve ``auto`` to ``chunked``, as every mixer is ``attn``."""
    jeng, teng = _engines(arch, backend)
    assert teng.prefill_strategy == jeng.prefill_strategy == "chunked"
    prompts = _prompts()
    jout, tout = _run(jeng, prompts), _run(teng, prompts)
    assert tout == jout
    assert all(len(t) == GEN for t in tout.values())
    assert len({x for t in tout.values() for x in t}) > 8   # not one token
    assert teng.stats.prefill_chunks == jeng.stats.prefill_chunks == 6
    assert teng.decode_graphs.builds == 1
    assert teng.pool.num_free == TRACE["max_slots"]


def test_moe_engine_launch_count_on_cpu_is_zero():
    """On the CPU the expert-batched projections take the kernels' plain
    versions and count nothing (on the card each counts one launch of
    each kernel: ``tests/test_torch_gpu.py``)."""
    K.reset_launch_counts()
    _, teng = _engines("granite_moe_3b_a800m", "pallas")
    _run(teng, _prompts()[:2], 3)
    assert teng.launches(K.launch_counts) == {
        "score_select": 0, "sparse_matmul_shared": 0,
        "sparse_matmul_per_seq": 0, "score_select_experts": 0,
        "sparse_matmul_shared_experts": 0}


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_67b"])
def test_scratch_shapes_cover_the_expert_launches(arch):
    """The matmul shapes whose split-K scratch a card engine reserves
    before its first capture: each attention (and dense MLP) weight at
    the decode and chunk rows, each expert weight once for all E experts
    at the rows an expert sees in decode (4 slots x C(1) = 4) and in a
    chunk (C(16) = 11).  Read from a CPU engine posing as a card one
    (the method reads shapes only)."""
    m = _model(arch)
    _, teng = _engines(arch, "pallas")
    teng.device = torch.device("cuda")
    shapes = set(teng._scratch_shapes())
    cfg = m["cfg"]
    d, hd = cfg.d_model, cfg.head_dim
    attn = {(B, d, m_, 16, 4, 1) for B in (4, 16)
            for m_ in (cfg.num_heads * hd, cfg.num_kv_heads * hd)} | \
        {(B, cfg.num_heads * hd, d, 16, 4, 1) for B in (4, 16)}
    if cfg.num_experts:
        E, f = cfg.num_experts_padded, cfg.expert_d_ff
        ffn = {(R, n, m_, 16, 4, E) for R in (4, 11)
               for n, m_ in ((d, f), (f, d))}
    else:
        ffn = {(B, n, m_, 16, 4, 1) for B in (4, 16)
               for n, m_ in ((d, cfg.d_ff), (cfg.d_ff, d))}
    assert shapes == attn | ffn


@pytest.mark.parametrize("kind", ["decode", "chunk", "verify"])
def test_inactive_steps_write_only_what_a_build_puts_back(kind):
    """A build's warm call runs its step on the inactive inputs: decode
    every slot at the scratch position, a chunk at slot 0 from
    ``max_len``, a verify every slot's last ``gamma + 1`` positions.  It
    writes nothing outside the columns the build puts back
    (``_Steps.written``: ``graphs.scratch_columns`` and
    ``graphs.window_columns``), so after a build the pool is as it was.
    That matters for MoE: an inactive decode row attends its slot's
    slack, and its expert rows join each expert's shared block
    selection."""
    m = _model("granite_moe_3b_a800m")
    cfg = m["cfg"]
    S, max_len, C, g1 = 3, 40, 16, 3
    pool_len = max_len + C
    rng = np.random.default_rng(13)
    caches = P.from_numpy(jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        japi.cache_schema(m["jcfg"], S, pool_len),
        is_leaf=lambda s: hasattr(s, "init")))
    before = P.tree_map(torch.clone, caches)
    sp = default_sp_stacked(m["params"], cfg, keep_frac=0.5,
                            tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    with torch.no_grad():
        if kind == "decode":
            cols = graphs.scratch_columns(caches, pool_len - 1)
            ref_cols = graphs.scratch_columns(before, pool_len - 1)
            api.make_slot_decode_step(cfg)(
                m["params"], torch.zeros(S, dtype=torch.long),
                torch.full((S,), pool_len - 1), caches, sp, torch.zeros(S),
                policy=pol)
        elif kind == "chunk":
            cols = graphs.window_columns(caches, slice(0, 1), max_len, C)
            ref_cols = graphs.window_columns(before, slice(0, 1), max_len, C)
            api.make_chunk_prefill_step(cfg)(
                m["params"], torch.zeros(1, C, dtype=torch.long),
                torch.full((1,), max_len), torch.tensor(0), caches, sp,
                torch.zeros(C), policy=pol)
        else:
            cols = graphs.window_columns(caches, slice(None),
                                         pool_len - g1, g1)
            ref_cols = graphs.window_columns(before, slice(None),
                                             pool_len - g1, g1)
            api.make_verify_step(cfg)(
                m["params"], torch.zeros(S, g1, dtype=torch.long),
                torch.full((S,), pool_len - g1), caches, sp,
                torch.zeros(S, g1), policy=pol)
    assert not all(torch.equal(a, b) for a, b in zip(cols, ref_cols))
    for c, kept in zip(cols, ref_cols):
        c.copy_(kept)
    for a, b in zip(P.to_numpy(caches)[0], P.to_numpy(before)[0]):
        for n in ("k", "v"):
            assert np.array_equal(a["self"][n], b["self"][n])


# ---------------------------------------------------------------------------
# deepseek_67b, reduced: logits against JAX
# ---------------------------------------------------------------------------

def _pool(m, slots, T, seed):
    rng = np.random.default_rng(seed)
    shapes = japi.cache_schema(m["jcfg"], slots, T)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        shapes, is_leaf=lambda s: hasattr(s, "init"))


def _caches_close(jc, tc):
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(P.to_numpy(tc))):
        _close(b, a)


@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
@pytest.mark.parametrize("mode", ["prefill", "decode", "chunk"])
def test_deepseek_logits_match_jax(mode, backend):
    m = _model("deepseek_67b")
    jsp = _with_tau(m["jsp"], 0.02)
    sp = P.from_numpy(_np(jsp))
    jpol, tpol = _policies(backend)
    rng = np.random.default_rng(5)
    kw, jkw = {}, {}
    if mode == "prefill":
        toks = rng.integers(0, 256, (2, 12))
    elif mode == "decode":
        toks = np.array([5, 77, 200], np.int32)
        caches = _pool(m, 3, 16, seed=7)
        pos = np.array([3, 9, 15], np.int32)
        active = np.array([1.0, 0.0, 1.0], np.float32)
        jkw = dict(caches=jax.tree_util.tree_map(jnp.asarray, caches),
                   positions=jnp.asarray(pos),
                   token_weights=jnp.asarray(active))
        kw = dict(caches=P.from_numpy(caches),
                  positions=torch.from_numpy(pos),
                  token_weights=torch.from_numpy(active))
    else:
        toks = rng.integers(0, 256, (1, 8))
        caches = _pool(m, 2, 32, seed=8)
        weights = np.array([1] * 6 + [0] * 2, np.float32)
        jkw = dict(caches=jax.tree_util.tree_map(jnp.asarray, caches),
                   positions=jnp.full((1,), 5, jnp.int32), slot=jnp.int32(1),
                   token_weights=jnp.asarray(weights))
        kw = dict(caches=P.from_numpy(caches), positions=torch.full((1,), 5),
                  slot=torch.tensor(1), token_weights=torch.from_numpy(weights))
    jl, jc = JM.forward(m["jparams"], m["jcfg"], tokens=jnp.asarray(toks),
                        mode=mode, sp=jsp, policy=jpol, **jkw)
    tl, tc = TM.forward(m["params"], m["cfg"], tokens=torch.from_numpy(toks),
                        mode=mode, sp=sp, policy=tpol, **kw)
    _close(tl, jl)
    _caches_close(jc, tc)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_engine_admits_the_granites_and_refuses_ssm_and_vlm():
    """The granites (and, since the SSM slice, mamba2_130m and the jamba
    hybrid) build their caches; enc-dec (whisper) and the VLM prefix
    (internvl2) stay refused at the engine's door."""
    for name in GRANITES + ["mamba2_130m", "jamba_v01_52b"]:
        TM.check_supported(get_config(name))
        api.init_caches(reduced(get_config(name)), 2, 8, device="cpu")
    for name in ("whisper_large_v3", "internvl2_26b"):
        with pytest.raises(NotImplementedError):
            Engine(None, get_config(name), EngineConfig(), device="cpu")


# ---------------------------------------------------------------------------
# step costs
# ---------------------------------------------------------------------------

def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            fn()
    return fc.get_total_flops()


def _hand_bytes(cfg, params, ecfg, frac, rows):
    """Bytes by hand: the embedding rows, every attention weight, the
    router and all E experts' weights (times the kept fraction where the
    backend gathers), the norms, the tied head (the embedding once more)
    and the K/V of ``slots`` slots at the pool length."""
    elem = 4
    proj = other = 0
    for group in params["groups"]:
        for layer in group.values():
            other += layer["ln1"].nbytes + layer["ln2"].nbytes
            proj += sum(w.nbytes for w in layer["attn"].values())
            proj += sum(layer["moe"][k].nbytes
                        for k in ("wi_gate", "wi_up", "wo"))
            other += layer["moe"]["router"].nbytes
    return (rows * cfg.d_model * elem + proj * frac + other
            + params["final_norm"].nbytes + params["embed"].nbytes)


@pytest.mark.parametrize("backend", ["off", "topk_shared", "pallas"])
@pytest.mark.parametrize("phase", ["decode", "chunk", "verify"])
def test_step_costs_of_moe_layers_equal_the_flop_counter(phase, backend):
    """The router product and the 4 experts x (groups x C) rows x three
    projections per MoE layer, as the port computes them, against
    ``FlopCounterMode`` on the step itself; bytes against a hand sum."""
    m = _model("granite_moe_3b_a800m")
    cfg, params = m["cfg"], m["params"]
    ecfg = EngineConfig(max_slots=3, max_len=40, prefill_chunk=16)
    dense = backend == "off"
    policy = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    sp = None if dense else default_sp_stacked(params, cfg, keep_frac=0.5,
                                               tau=float("-inf"))
    S, T = ecfg.max_slots, ecfg.pool_len
    caches = api.init_caches(cfg, S, T, device="cpu")
    gamma = 2
    if phase == "decode":
        step = api.make_slot_decode_step(cfg)
        rows = S
        counted = _counted(lambda: step(
            params, torch.zeros(S, dtype=torch.long), torch.arange(S) + 20,
            caches, sp, torch.ones(S), policy=policy))
    elif phase == "chunk":
        step = api.make_chunk_prefill_step(cfg)
        rows = 16
        counted = _counted(lambda: step(
            params, torch.zeros(1, 16, dtype=torch.long),
            torch.zeros(1, dtype=torch.long), torch.tensor(0), caches, sp,
            torch.ones(16), policy=policy))
    else:
        step = api.make_verify_step(cfg)
        rows = S * (gamma + 1)
        counted = _counted(lambda: step(
            params, torch.zeros(S, gamma + 1, dtype=torch.long),
            torch.arange(S) + 10, caches, sp, torch.ones(S, gamma + 1),
            policy=policy))
    flops, nbytes = step_costs(cfg, ecfg, policy, sp, phase, gamma=gamma)
    assert flops == pytest.approx(counted, rel=1e-9)
    kv = sum(2 * (1 if phase == "chunk" else S) * cfg.num_kv_heads
             * cfg.head_dim * 4 * T for _ in cfg.layer_kinds())
    assert nbytes == pytest.approx(
        _hand_bytes(cfg, params, ecfg, 1.0 if dense else 0.5, rows) + kv,
        rel=1e-12)


def test_step_costs_of_full_width_granite_decode():
    """A full-width granite_moe_3b_a800m decode step at 8 slots and a
    544-position pool reads all 48 experts' weights (7.25 GB in bf16),
    the attention's (0.40 GB), the tied head (0.15 GB) and the K/V (0.29
    GB): 8.09 GB; under ``pallas`` at 0.5 on the experts alone, half the
    expert bytes less.  Counted as a dense d_ff = 512 MLP, the FFN would
    be 0.15 GB."""
    cfg = get_config("granite_moe_3b_a800m")
    ecfg = EngineConfig(max_slots=8, max_len=512, prefill_chunk=32)
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts_padded
    experts = 32 * 3 * E * d * f * 2
    kv = 32 * 2 * 8 * cfg.num_kv_heads * cfg.head_dim * ecfg.pool_len * 2
    assert round(experts / 1e9, 2) == 7.25 and round(kv / 1e9, 2) == 0.29
    _, dense = step_costs(cfg, ecfg, SparsityPolicy.dense(), None, "decode")
    assert round(dense / 1e9, 2) == 8.09
    sp = [{"l0": {"moe": {k: {} for k in ("wi_gate", "wi_up", "wo")}}}]
    _, sparse = step_costs(cfg, ecfg, SparsityPolicy.uniform(
        "pallas", k_max_frac=0.5), sp, "decode")
    assert dense - sparse == pytest.approx(experts / 2, rel=1e-12)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,argv", [
    ("granite_moe_1b_a400m", ["--mode", "pallas"]),
    ("granite_moe_3b_a800m", ["--mode", "topk_block"])])
def test_serve_cli_runs_the_granites(arch, argv, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "3",
                      *argv])
    assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())
    assert "generated 6 tokens" in capsys.readouterr().out


def test_serve_cli_refuses_moe_calibration(capsys):
    """(Named for the refusal it replaced.)  ``--calib-quick`` on a
    granite runs the reference CLI's stages (Alg. 3, 4, 2) and serves
    the plan, the sensitive blocks under ``mask``.  Its weights are the
    port's own init, so token parity with the JAX CLI is not asked here:
    ``tests/test_torch_calibration_moe.py`` holds the calibration and
    the served tokens against JAX on shared weights."""
    out = serve.main(["--arch", "granite_moe_1b_a400m", "--reduced",
                      "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                      "--gen", "2", "--calib-quick", "--mode", "pallas",
                      "--sensitive-backend", "mask"])
    text = capsys.readouterr().out
    for stage in ("coarse search: evolutionary block-level allocation "
                  "(Alg. 3)", "fine search: greedy intra-block allocation "
                  "(Alg. 4)", "alpha search: block-wise grid (Alg. 2)",
                  "calibrated plan:", "generated 4 tokens"):
        assert stage in text, stage
    assert sorted(out) == [0, 1] and all(len(t) == 2 for t in out.values())
