"""The port's engine on the SSM archs against the JAX engine, and what
the SSM layer changes around it: the slot pool's conv/ssm leaves, the
refused options, the step costs of a mamba layer, the matmul scratch an
engine reserves, and the decode build on a busy engine.

Reduced mamba2_130m (2 layers, d_model 64, 8 heads of 16, state 16, f32)
on weights initialised by JAX and carried across by
``models/params.from_numpy``; reduced jamba_v01_52b's engine runs are in
``tests/test_torch_jamba_engine.py``.  The engine trace: 4 slots,
``max_len`` 64, prompts of 20, 9 and 33 tokens (each its own whole-prompt
prefill), 8 new tokens each; one slot stays free.  Greedy tokens are
compared for exact equality.  Sparse backends run with ``block=16``,
``k_max_frac=0.5`` and an sp tree at ``keep_frac=0.5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving.kv_pool import SlotKVPool as JSlotKVPool
from repro.serving.kv_pool import SuspendedSlot as JSuspendedSlot
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.sparsity import PolicyLadder as JLadder
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.kernels import sparse_matmul as K
from repro_torch.launch import serve
from repro_torch.launch.roofline import step_costs
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.serving import (Engine, EngineConfig, SchedulerConfig,
                                 SlotKVPool, graphs)
from repro_torch.serving.engine import _whole_rows
from repro_torch.serving.kv_pool import SuspendedSlot
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.spec import SpecConfig
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ARCHS = ["mamba2_130m", "jamba_v01_52b"]
TRACE = dict(max_slots=4, max_len=64, prefill_chunk=16)
PROMPT_LENS = (20, 9, 33)
GEN = 8
# uncalibrated pallas serves at tau -inf (the reference's +inf zeroes
# every projection); mask thresholds at a finite tau
TAUS = {"off": None, "mask": 0.05, "pallas": -np.inf}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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


def engines(arch, backend, frac=0.5):
    """(JAX engine, port engine) on the same weights, policy and sp."""
    m = _model(arch)
    tau = TAUS[backend]
    jsp = None if tau is None else _with_tau(m["jsp"], tau)
    kw = dict(k_max_frac=0.5, block=16)
    ekw = dict(TRACE, prefill_dense_frac=frac)
    jeng = JEngine(m["jparams"], m["jcfg"], JEngineConfig(
        policy=JPolicy.uniform(backend, interpret=True, **kw), **ekw), jsp)
    teng = Engine(m["params"], m["cfg"], EngineConfig(
        policy=SparsityPolicy.uniform(backend, **kw), **ekw),
        None if jsp is None else P.from_numpy(_np(jsp)), device="cpu")
    return jeng, teng


def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


def run(eng, ps, gen=GEN):
    for p in ps:
        eng.submit(p, gen)
    return eng.run()


def check_tokens(arch, backend, frac=0.5):
    """Whole-prompt prefill of each ragged prompt, then batched decode
    with a free slot: exactly the JAX engine's greedy tokens."""
    jeng, teng = engines(arch, backend, frac)
    assert teng.prefill_strategy == jeng.prefill_strategy == "whole"
    ps = prompts()
    jout, tout = run(jeng, ps), run(teng, ps)
    assert tout == jout
    assert all(len(t) == GEN for t in tout.values())
    assert len({x for t in tout.values() for x in t}) > 12   # not one token
    assert teng.stats.prefill_chunks == jeng.stats.prefill_chunks == 3
    assert teng.decode_graphs.builds == 1
    assert teng.pool.num_free == TRACE["max_slots"]


@pytest.mark.parametrize("backend,frac", [
    ("off", 0.5), ("mask", 0.5), ("pallas", 0.5), ("pallas", 0.0)])
def test_mamba2_engine_tokens_equal_jax(backend, frac):
    """``prefill_dense_frac`` 0 runs the whole prompts sparse."""
    check_tokens("mamba2_130m", backend, frac)


def test_whole_prefill_launch_count_on_cpu_is_zero():
    """On the CPU the sparse projections take the kernels' plain versions
    and count nothing; on the card each counts one launch of each
    kernel (``tests/test_torch_gpu.py``)."""
    K.reset_launch_counts()
    _, teng = engines("mamba2_130m", "pallas", 0.0)
    run(teng, prompts()[:2], 3)
    assert not any(teng.launches(K.launch_counts).values())


# ---------------------------------------------------------------------------
# guards: what the JAX engine refuses on an SSM arch, the port refuses too
# ---------------------------------------------------------------------------

GUARDS = ["spec", "prefix_cache", "chunked", "preemption", "quality_probe"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("guard", GUARDS)
def test_options_refused_as_the_jax_engine_refuses_them(arch, guard):
    """Chunked prefill, speculative decoding, the prefix cache,
    preemption and the quality probe: the reference's exception type and
    message head."""
    m = _model(arch)
    base = dict(max_slots=2, max_len=64, prefill_chunk=16)
    j_kw, t_kw, j_args, t_args = {}, {}, {}, {"device": "cpu"}
    if guard == "spec":
        jl = JLadder.uniform(m["jparams"], m["jcfg"], budgets=(0.0, 0.5))
        j_args["ladder"] = jl
        t_args["ladder"] = PolicyLadder(
            budgets=jl.budgets,
            policies=tuple(SparsityPolicy.from_dict(p.to_dict())
                           for p in jl.policies),
            sps=tuple(P.from_numpy(_np(sp)) for sp in jl.sps))
        j_kw["spec"] = JSpecConfig(gamma=2, drafter_rung=1)
        t_kw["spec"] = SpecConfig(gamma=2, drafter_rung=1)
    elif guard == "prefix_cache":
        j_kw["prefix_cache"] = t_kw["prefix_cache"] = True
    elif guard == "chunked":
        j_kw["prefill_strategy"] = t_kw["prefill_strategy"] = "chunked"
    elif guard == "preemption":
        j_kw["scheduler"] = JSchedulerConfig(preemption=True)
        t_kw["scheduler"] = SchedulerConfig(preemption=True)
    else:
        j_args["telemetry"] = jobs.Telemetry(
            quality=jobs.QualityMonitor(probe_rate=1.0))
        t_args["telemetry"] = obs.Telemetry(
            quality=obs.QualityMonitor(probe_rate=1.0))
    with pytest.raises(Exception) as jexc:
        JEngine(m["jparams"], m["jcfg"], JEngineConfig(**base, **j_kw),
                **j_args)
    with pytest.raises(Exception) as texc:
        Engine(m["params"], m["cfg"], EngineConfig(**base, **t_kw),
               **t_args)
    assert type(texc.value) is type(jexc.value)
    assert type(texc.value) in (ValueError, NotImplementedError)
    assert str(texc.value).split(":")[0].split(" (")[0] == \
        str(jexc.value).split(":")[0].split(" (")[0]


# ---------------------------------------------------------------------------
# the slot pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pool_holds_conv_and_ssm_leaves_and_refuses_segments(arch):
    """``SlotKVPool`` builds the reference's cache tree (conv leaves in
    the model dtype, ``ssm`` in f32; jamba's attention and mamba entries
    in one stacked group), cannot cache a prefix, and refuses segments,
    suspend, resume and rollback with the reference pool's exception
    types (the prefix cache's messages too)."""
    m = _model(arch)
    pool = SlotKVPool(m["cfg"], 3, 16, device="cpu")
    jpool = JSlotKVPool(m["jcfg"], 3, 16)
    assert jax.tree_util.tree_structure(P.to_numpy(pool.caches)) == \
        jax.tree_util.tree_structure(_np(jpool.caches))
    for a, b in zip(jax.tree_util.tree_leaves(P.to_numpy(pool.caches)),
                    jax.tree_util.tree_leaves(jpool.caches)):
        assert a.shape == b.shape and a.dtype == b.dtype
    kinds = [set(e) for g in pool.caches for e in g]
    assert {"ssm"} in kinds
    assert ({"self"} in kinds) == (arch == "jamba_v01_52b")
    assert not pool.can_cache_prefix and not jpool.can_cache_prefix
    msgs = []
    for cls, p in ((JPrefixCache, jpool), (PrefixCache, pool)):
        with pytest.raises(ValueError, match="full-length self-attention") \
                as exc:
            cls(p, chunk=8)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    pref = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32),
        japi.cache_schema(m["jcfg"], 1, 5),
        is_leaf=lambda s: hasattr(s, "init"))
    jpool.insert(pref, 0, jpool.alloc(), 5)
    pool.insert(P.from_numpy(pref), 0, pool.alloc(), 5)
    calls = [("extract_prefix", lambda p, _ss: p.extract_prefix(0, 4)),
             ("write_prefix", lambda p, _ss: p.write_prefix(None, 0)),
             ("suspend", lambda p, _ss: p.suspend(0, 4)),
             ("resume", lambda p, ss: p.resume(ss(caches=None, length=4,
                                                  phys=4), 0)),
             ("rollback", lambda p, _ss: p.rollback(0, 2))]
    for name, call in calls:
        excs = []
        for p, ss in ((jpool, JSuspendedSlot), (pool, SuspendedSlot)):
            with pytest.raises(Exception) as exc:
                call(p, ss)
            excs.append(exc.value)
        assert type(excs[1]) is type(excs[0]) is ValueError, name
        if name != "suspend":
            assert str(excs[1]) == str(excs[0]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_insert_copies_whole_conv_and_ssm_rows_as_the_jax_pool(arch):
    """Request 1 of a random 2-row prefill cache tree (K/V of 7
    positions on jamba's attention layer) into slot 2 of a random pool:
    the port's pool equals the JAX pool after the same insert."""
    m = _model(arch)
    rng = np.random.default_rng(3)

    def rand(schema):
        return jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32),
            schema, is_leaf=lambda s: hasattr(s, "init"))
    start = rand(japi.cache_schema(m["jcfg"], 3, 16))
    pref = rand(japi.cache_schema(m["jcfg"], 2, 7))
    jpool = JSlotKVPool(m["jcfg"], 3, 16)
    jpool.caches = jax.tree_util.tree_map(jnp.asarray, start)
    pool = SlotKVPool(m["cfg"], 3, 16, device="cpu")
    pool.caches = P.from_numpy(start)
    for p in (jpool, pool):
        p.alloc(), p.alloc()
        p.insert(jax.tree_util.tree_map(jnp.asarray, pref) if p is jpool
                 else P.from_numpy(pref), 1, p.alloc(), 7)
    for a, b in zip(jax.tree_util.tree_leaves(_np(jpool.caches)),
                    jax.tree_util.tree_leaves(P.to_numpy(pool.caches))):
        assert np.array_equal(a, b)
    assert list(pool.lengths) == list(jpool.lengths) == [0, 0, 7]


# ---------------------------------------------------------------------------
# the decode build on a busy engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_decode_writes_only_what_a_build_puts_back(arch):
    """A decode build's warm call runs every slot inactive: on a mamba
    layer that advances every slot's conv windows and state, on jamba's
    attention layer it writes the scratch column.  ``DecodeSteps.written``
    names all of it, so a build leaves every live slot's rows bit-equal
    (on the card: ``tests/test_torch_gpu.py``)."""
    m = _model(arch)
    cfg = m["cfg"]
    S, pool_len = 3, 40
    rng = np.random.default_rng(13)
    caches = P.from_numpy(jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        japi.cache_schema(m["jcfg"], S, pool_len),
        is_leaf=lambda s: hasattr(s, "init")))
    before = P.tree_map(torch.clone, caches)
    sp = default_sp_stacked(m["params"], cfg, keep_frac=0.5,
                            tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    steps = graphs.DecodeSteps(
        api.make_slot_decode_step(cfg), m["params"], caches, [(pol, sp)], S,
        pool_len - 1, graphs.GraphSpace(torch.device("cpu")))
    cols = steps.written(0)
    assert len(graphs.ssm_leaves(caches)) == 4 * sum(
        1 for mixer, _ in cfg.layer_pattern if mixer == "mamba")
    saved = [c.clone() for c in cols]
    with torch.no_grad():
        steps._eager(0, torch.zeros(S, dtype=torch.long),
                     torch.full((S,), pool_len - 1), torch.zeros(S))
    assert not all(torch.equal(a, b) for a, b in zip(cols, saved))
    for c, kept in zip(cols, saved):
        c.copy_(kept)
    for a, b in zip(jax.tree_util.tree_leaves(P.to_numpy(caches)),
                    jax.tree_util.tree_leaves(P.to_numpy(before))):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# step costs and the matmul scratch
# ---------------------------------------------------------------------------

def _hand_bytes(cfg, params, S, frac, rows, T):
    """Bytes by hand: the embedding rows; every projection weight (times
    the kept fraction where the backend gathers); the conv weights,
    A_log, D, dt_bias and every norm; every slot's conv windows and f32
    state, read and written; the K/V of every slot at the pool length on
    an attention layer; the router and all experts on a MoE one; the
    tied head (the embedding once more)."""
    elem = 4
    proj = other = state = 0
    for group in params["groups"]:
        for layer in group.values():
            for k, v in layer.items():
                if k.startswith("ln"):
                    other += v.nbytes
            mix = layer.get("mamba", layer.get("attn"))
            for k, w in mix.items():
                if k in ("in_z", "in_x", "in_B", "in_C", "in_dt",
                         "out_proj", "wq", "wk", "wv", "wo"):
                    proj += w.nbytes
                else:
                    other += w.nbytes
            for ffn in ("mlp", "moe"):
                for k, w in layer.get(ffn, {}).items():
                    if k == "router":
                        other += w.nbytes
                    else:
                        proj += w.nbytes
            reps = next(iter(layer["ln1"].shape))
            if "mamba" in layer:
                state += 2 * reps * S * ((cfg.ssm_conv - 1) * (
                    cfg.d_inner + 2 * cfg.ssm_state) * elem
                    + cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4)
            else:
                state += reps * 2 * S * cfg.num_kv_heads * cfg.head_dim * \
                    elem * T
    return (rows * cfg.d_model * elem + proj * frac + other + state
            + params["final_norm"].nbytes + params["embed"].nbytes)


@pytest.mark.parametrize("backend", ["off", "topk_shared", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_costs_of_mamba_layers(arch, backend):
    """A decode step's FLOPs against ``FlopCounterMode`` on the step
    itself (the projections, the conv taps, the state's read-out; the
    state update is elementwise), and its bytes against a hand count.
    Chunk and verify steps do not exist on an SSM arch."""
    m = _model(arch)
    cfg, params = m["cfg"], m["params"]
    ecfg = EngineConfig(max_slots=3, max_len=40, prefill_chunk=16)
    dense = backend == "off"
    policy = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    sp = None if dense else default_sp_stacked(params, cfg, keep_frac=0.5,
                                               tau=float("-inf"))
    S, T = ecfg.max_slots, ecfg.pool_len
    caches = api.init_caches(cfg, S, T, device="cpu")
    step = api.make_slot_decode_step(cfg)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            step(params, torch.zeros(S, dtype=torch.long),
                 torch.arange(S) + 20, caches, sp, torch.ones(S),
                 policy=policy)
    flops, nbytes = step_costs(cfg, ecfg, policy, sp, "decode")
    assert flops == pytest.approx(fc.get_total_flops(), rel=1e-9)
    assert nbytes == pytest.approx(
        _hand_bytes(cfg, params, S, 1.0 if dense else 0.5, S, T), rel=1e-12)
    for phase in ("chunk", "verify"):
        with pytest.raises(ValueError, match="SSM"):
            step_costs(cfg, ecfg, policy, sp, phase, gamma=1)


def test_step_costs_of_full_width_mamba2_decode():
    """Full-width mamba2_130m at 8 slots: 144 projection weights (0.18
    GB in bf16), the tied head (0.077 GB), and the f32 SSM state of every
    slot read and written (0.151 GB each way, 0.302 GB in all; the conv
    windows add 2 x 2.06 MB).  Under ``pallas`` at 0.5 the projections'
    bytes halve (in_dt's 768 rows: 6 blocks, 3 kept) and the state stays."""
    cfg = get_config("mamba2_130m")
    ecfg = EngineConfig(max_slots=8, max_len=8448, prefill_chunk=32)
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    proj = 24 * (2 * d * di + 2 * d * N + d * H + di * d) * 2
    ssm = 24 * 8 * H * cfg.ssm_head_dim * N * 4
    conv = 24 * 8 * 3 * (di + 2 * N) * 2
    assert round(proj / 1e9, 2) == 0.18 and round(ssm / 1e9, 3) == 0.151
    assert round(conv / 1e6, 2) == 2.06
    _, dense = step_costs(cfg, ecfg, SparsityPolicy.dense(), None, "decode")
    other = 8 * d * 2 + 24 * (4 * (di + 2 * N) * 2 + 3 * H * 4 + di * 2
                              + d * 2) + d * 2 + cfg.vocab_size * d * 2
    assert dense == proj + 2 * (ssm + conv) + other
    sp = [{"l0": {"mamba": {k: {} for k in ("in_z", "in_x", "in_B", "in_C",
                                            "in_dt", "out_proj")}}}]
    _, sparse = step_costs(cfg, ecfg, SparsityPolicy.uniform(
        "pallas", k_max_frac=0.5), sp, "decode")
    assert dense - sparse == pytest.approx(proj / 2, rel=1e-12)


@pytest.mark.parametrize("frac", [0.5, 0.0])
def test_scratch_shapes_cover_the_mamba_launches(frac):
    """The matmul shapes whose split-K scratch a card engine reserves
    before its first capture: the six mamba projections at the decode
    rows (4 slots) and, where the whole-prompt prefill runs sparse
    (``prefill_dense_frac`` 0), at every row count a whole prompt can
    bring whose plan splits (``_whole_rows``).  Read from a CPU engine
    posing as a card one (the method reads shapes only)."""
    _, teng = engines("mamba2_130m", "pallas", frac)
    teng.device = torch.device("cuda")
    shapes = set(teng._scratch_shapes())
    cfg = teng.cfg
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    want = set()
    for n, m_ in ((d, di), (d, di), (d, N), (d, N), (d, H), (di, d)):
        rows = {4}
        if frac == 0.0:
            rows |= _whole_rows(n, m_, 16, 4, 1, 4 * 64)
        want |= {(B, n, m_, 16, 4, 1) for B in rows}
    assert shapes == want
    if frac == 0.0:
        assert len(shapes) > 6
        for B, n, m_, blk, elem, E in shapes:
            assert B == 4 or K.launch_plan(B, n, m_, n // blk, blk, False,
                                           elem, E).splits > 1


def test_whole_rows_bound_every_whole_prompt_plan():
    """For every row count up to 2048, the split-K workspace and counters
    its plan needs are at most those of a count ``_whole_rows`` gives."""
    for n, m_ in ((768, 1536), (768, 24), (1536, 768)):
        rows = _whole_rows(n, m_, 128, 2, 1, 2048)
        ws = max(K.launch_plan(b, n, m_, n // 128, 128, False, 2).workspace
                 for b in rows)
        cnt = max(K.launch_plan(b, n, m_, n // 128, 128, False, 2).counters
                  for b in rows)
        for B in range(1, 2049):
            plan = K.launch_plan(B, n, m_, n // 128, 128, False, 2)
            assert plan.workspace <= ws and plan.counters <= cnt, (n, m_, B)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--mode", "pallas"],
                                  ["--mode", "topk_shared",
                                   "--prefill-strategy", "whole"],
                                  ["--mode", "pallas", "--calib-quick"]])
def test_serve_cli_runs_mamba2(argv, capsys):
    out = serve.main(["--arch", "mamba2_130m", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "17", "--gen", "3",
                      *argv])
    assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())
    assert "generated 6 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("argv,err", [
    (["--prefix-cache", "--sparsity", "0"], ValueError),
    (["--prefill-strategy", "chunked"], ValueError),
    (["--preemption"], ValueError),
    (["--quality-probe-rate", "1.0", "--sparsity", "0"],
     NotImplementedError)])
def test_serve_cli_refuses_what_mamba2_cannot_run(argv, err):
    with pytest.raises(err):
        serve.main(["--arch", "mamba2_130m", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "17", "--gen", "3",
                    *argv])
