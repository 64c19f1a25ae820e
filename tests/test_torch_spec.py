"""The port's speculative decoding and its chunk step with device offsets
against the JAX package, on the reduced llama31_8b (f32) with
JAX-initialised weights and the same ladders.

Ladders are ``PolicyLadder.uniform`` at budgets (0.0, 0.5): rung 0 dense
(the verifier), rung 1 the drafter.  ``topk_shared`` is the reference
tests' drafter; a ``pallas`` ladder's sp trees get ``tau=-inf`` on both
sides (the reference's uncalibrated ``+inf`` zeroes every ``pallas``
projection), and on the CPU the port's ``pallas`` runs the kernels'
plain versions.  The step tests compare logits at 1e-5 (f32); the
engine tests compare greedy tokens, spec counters and controller
decisions for exact equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig, SyntheticLM
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SlotKVPool as JPool
from repro.serving import SLOConfig as JSLOConfig
from repro.serving import SpecConfig as JSpecConfig
from repro.serving import SpecController as JSpecController
from repro.sparsity import PolicyLadder as JLadder
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.serving import (Engine, EngineConfig, SLOConfig, SlotKVPool,
                                 SpecConfig, SpecController)
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

ATOL = 1e-5
TRACE = dict(max_slots=2, max_len=32, prefill_chunk=8)
LENS = (9, 14, 20, 11)
GEN = 6


def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


def _ladders(jparams, jcfg, backend):
    jl = JLadder.uniform(jparams, jcfg, budgets=(0.0, 0.5), backend=backend)
    if backend == "pallas":
        jl = JLadder(budgets=jl.budgets, policies=jl.policies,
                     sps=tuple(_with_tau(sp, -jnp.inf) for sp in jl.sps))
    tl = PolicyLadder(
        budgets=jl.budgets,
        policies=tuple(SparsityPolicy.from_dict(p.to_dict())
                       for p in jl.policies),
        sps=tuple(P.from_numpy(jax.tree_util.tree_map(np.asarray, sp))
                  for sp in jl.sps))
    return jl, tl


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    return dict(jcfg=jcfg, jparams=jparams,
                params=P.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams)),
                cfg=reduced(get_config("llama31_8b")),
                ladders={b: _ladders(jparams, jcfg, b)
                         for b in ("topk_shared", "pallas")})


def _prompts(cfg, n, seq, step=0):
    return np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, n)).batch(step))


def _pool(jcfg, slots, T, seed):
    rng = np.random.default_rng(seed)
    shapes = japi.cache_schema(jcfg, slots, T)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        shapes, is_leaf=lambda s: hasattr(s, "init"))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the steps: chunk with device offset/slot, verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["off", "topk_shared", "pallas"])
@pytest.mark.parametrize("off,slot", [(0, 0), (5, 2)])
def test_chunk_step_with_device_offset_matches_jax(model, backend, off,
                                                   slot):
    """The chunk step takes the reference's argument types: ``offset``
    (1,) and ``slot`` 0-d int tensors.  Logits and the whole pool equal
    the JAX step's."""
    jl, tl = model["ladders"]["pallas" if backend == "pallas"
                              else "topk_shared"]
    kw = dict(k_max_frac=0.5)
    jpol = JPolicy.uniform(backend, interpret=True, **kw)
    tpol = SparsityPolicy.uniform(backend, **kw)
    caches = _pool(model["jcfg"], 3, 24, seed=8)
    toks = np.random.default_rng(9).integers(0, 256, (1, 8))
    weights = np.array([1] * 6 + [0] * 2, np.float32)
    jlog, jc = japi.make_chunk_prefill_step(model["jcfg"])(
        model["jparams"], jnp.asarray(toks), jnp.full((1,), off, jnp.int32),
        jnp.int32(slot), jax.tree_util.tree_map(jnp.asarray, caches),
        jl.sps[1], jnp.asarray(weights), policy=jpol)
    tc = P.from_numpy(caches)
    tlog, out = api.make_chunk_prefill_step(model["cfg"])(
        model["params"], torch.from_numpy(toks), torch.full((1,), off),
        torch.tensor(slot), tc, tl.sps[1], torch.from_numpy(weights),
        policy=tpol)
    assert out is tc                             # the pool, written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    for a, b in zip(_leaves(jc), _leaves(P.to_numpy(tc))):
        np.testing.assert_allclose(b, a, atol=ATOL)


def test_verify_step_matches_jax(model):
    """Per-row offsets (one inactive row in the slack), written in place
    before the window attends: logits and pool equal the JAX step's."""
    g1 = 4
    caches = _pool(model["jcfg"], 3, 24, seed=3)
    toks = np.random.default_rng(4).integers(0, 256, (3, g1))
    pos = np.array([7, 24 - g1, 0], np.int64)
    wts = np.repeat(np.array([1.0, 0.0, 1.0], np.float32)[:, None], g1, 1)
    jlog, jc = japi.make_verify_step(model["jcfg"])(
        model["jparams"], jnp.asarray(toks), jnp.asarray(pos, jnp.int32),
        jax.tree_util.tree_map(jnp.asarray, caches), None,
        jnp.asarray(wts), policy=JPolicy.dense())
    tc = P.from_numpy(caches)
    tlog, _ = api.make_verify_step(model["cfg"])(
        model["params"], torch.from_numpy(toks), torch.from_numpy(pos), tc,
        None, torch.from_numpy(wts), policy=SparsityPolicy.dense())
    assert tlog.shape == (3, g1, model["cfg"].vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    for a, b in zip(_leaves(jc), _leaves(P.to_numpy(tc))):
        np.testing.assert_allclose(b, a, atol=ATOL)


def _clone(tree):
    return P.tree_map(lambda t: t.clone(), tree)


def _prefill_slot(model, pool, slot, prompt):
    chunk = api.make_chunk_prefill_step(model["cfg"])
    n = prompt.shape[0]
    chunk(model["params"], torch.from_numpy(prompt[None].astype(np.int64)),
          torch.zeros(1, dtype=torch.long), torch.tensor(slot), pool.caches,
          None, torch.ones(n), policy=SparsityPolicy.dense())
    pool.lengths[slot] = n


def test_verify_step_matches_sequential_decode(model):
    """One (g+1)-token verify gives the greedy tokens (and logits within
    1e-4) of g+1 sequential decode steps over the same tokens."""
    g1, plen = 4, 8
    cfg, params = model["cfg"], model["params"]
    dense = SparsityPolicy.dense()
    dstep = api.make_slot_decode_step(cfg)
    pool = SlotKVPool(cfg, 3, 20, device="cpu")
    slots = [pool.alloc(), pool.alloc()]         # slot 2 stays empty
    for s, pr in zip(slots, _prompts(cfg, 2, plen, step=2)):
        _prefill_slot(model, pool, s, pr)
    state0 = _clone(pool.caches)
    toks = _prompts(cfg, 3, g1, step=4).T.astype(np.int64)   # (g1, 3)
    active = np.zeros(3, np.float32)
    active[slots] = 1.0
    seq, caches = [], _clone(state0)
    for i in range(g1):
        pos = np.full(3, pool.max_len - 1)
        pos[slots] = plen + i
        lg, _ = dstep(params, torch.from_numpy(toks[i].copy()),
                      torch.from_numpy(pos), caches, None,
                      torch.from_numpy(active), policy=dense)
        seq.append(lg.numpy())
    pos = np.full(3, pool.max_len - g1)
    pos[slots] = plen
    vlg, _ = api.make_verify_step(cfg)(
        params, torch.from_numpy(toks.T.copy()), torch.from_numpy(pos),
        state0, None, torch.from_numpy(np.repeat(active[:, None], g1, 1)),
        policy=dense)
    for s in slots:
        for i in range(g1):
            a, b = seq[i][s], vlg[s, i].numpy()
            assert a.argmax() == b.argmax(), (s, i)
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_draft_rollback_redecode_is_bit_identical(model):
    """Decoding T tokens plainly, or drafting them under a sparse policy,
    rolling them back and redecoding them, gives bit-identical logits and
    caches: rejected drafts leave no trace."""
    T, plen = 4, 10
    cfg, params = model["cfg"], model["params"]
    _, tl = model["ladders"]["topk_shared"]
    sparse = SparsityPolicy.uniform("topk_shared", k_max_frac=0.5)
    dense = SparsityPolicy.dense()
    dstep = api.make_slot_decode_step(cfg)
    pool = SlotKVPool(cfg, 2, 24, device="cpu")
    slot = pool.alloc()
    _prefill_slot(model, pool, slot, _prompts(cfg, 1, plen, step=5)[0])
    state0 = _clone(pool.caches)
    toks = _prompts(cfg, 1, T, step=9)[0]
    active = torch.from_numpy(np.eye(2, dtype=np.float32)[slot])

    def step(caches, i, policy, sp):
        tv = np.zeros(2, np.int64)
        tv[slot] = toks[i]
        pos = np.full(2, pool.max_len - 1)
        pos[slot] = plen + i
        lg, _ = dstep(params, torch.from_numpy(tv), torch.from_numpy(pos),
                      caches, sp, active, policy=policy)
        return lg[slot].clone()

    plain = _clone(state0)
    want = [step(plain, i, dense, None) for i in range(T)]
    pool.caches = _clone(state0)
    for i in range(T):
        step(pool.caches, i, sparse, tl.sps[1])
    pool.commit(slot, T)
    pool.rollback(slot, T)
    assert pool.lengths[slot] == plen
    got = [step(pool.caches, i, dense, None) for i in range(T)]
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(P.to_numpy(plain)), _leaves(
            P.to_numpy(pool.caches))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the pool's commit/rollback bookkeeping against the JAX pool
# ---------------------------------------------------------------------------

_ops = st.lists(st.tuples(
    st.sampled_from(["rollback_many", "rollback", "commit", "commit",
                     "free", "alloc"]),
    st.sampled_from([0, 0, 1, 1, 2, 3]), st.integers(0, 4),
    st.integers(0, 2)),
    max_size=14)


def _apply(pool, op, slot, n, n2):
    try:
        if op == "alloc":
            return ("ok", pool.alloc())
        if op == "free":
            pool.free(slot)
        elif op == "commit":
            pool.commit(slot, n)
        elif op == "rollback":
            pool.rollback(slot, n)
        else:
            pool.rollback_many({slot: n, 1 - slot % 2: n2})
        return ("ok", None)
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@settings(max_examples=40, deadline=None)
@given(ops=_ops)
def test_commit_rollback_bookkeeping_equals_jax(model, ops):
    """Random alloc/free/commit/rollback sequences on a 3-slot pool with
    random contents, after slots 0 and 1 are allocated, committed and
    rolled back: the same results, errors and messages, lengths and cache
    bytes as the JAX pool (slot 3 is outside the pool in both)."""
    jpool = JPool(model["jcfg"], max_slots=3, max_len=8)
    tpool = SlotKVPool(model["cfg"], 3, 8, device="cpu")
    init = _pool(model["jcfg"], 3, 8, seed=len(ops))
    jpool.caches = jax.tree_util.tree_map(jnp.asarray, init)
    tpool.caches = P.from_numpy(init)
    start = [("alloc", 0, 0, 0)] * 2 + [("commit", 0, 4, 0),
                                        ("commit", 1, 4, 0),
                                        ("rollback_many", 0, 1, 2)]
    for op in start + ops:
        assert _apply(tpool, *op) == _apply(jpool, *op), op
        np.testing.assert_array_equal(tpool.lengths, jpool.lengths)
    for a, b in zip(_leaves(jpool.caches), _leaves(P.to_numpy(
            tpool.caches))):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# the spec engine
# ---------------------------------------------------------------------------

def _drive(eng, prompts, gen=GEN, mid=True):
    """Three requests, six steps, then a mid-flight fourth (more requests
    than slots, ragged prompts)."""
    for b in (0, 1, 2):
        eng.submit(prompts[b][:LENS[b]], gen)
    if mid:
        for _ in range(6):
            eng.step()
        eng.submit(prompts[3][:LENS[3]], gen)
    return eng.run()


def _spec_counters(stats):
    return {k: getattr(stats, k) for k in (
        "spec_rounds", "spec_draft_steps", "spec_verifies",
        "spec_draft_tokens", "spec_accepted_tokens", "spec_committed_tokens",
        "decode_steps", "decode_tokens")}


@pytest.mark.parametrize("backend", ["topk_shared", "pallas"])
def test_spec_engine_equals_jax_and_verifier_only(model, backend):
    """Same tokens as the JAX spec engine and as the port's verifier-only
    decode; the same spec counters as the JAX engine; nothing built
    after warmup; every token attributed to the verifier rung."""
    jl, tl = model["ladders"][backend]
    prompts = _prompts(model["cfg"], 4, 20, step=7)
    jeng = JEngine(model["jparams"], model["jcfg"], JEngineConfig(
        spec=JSpecConfig(gamma=2, drafter_rung=1), **TRACE), ladder=jl)
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        spec=SpecConfig(gamma=2, drafter_rung=1), **TRACE), ladder=tl,
        device="cpu")
    ref = Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
                 ladder=tl, device="cpu")
    jout, out, rout = (_drive(e, prompts) for e in (jeng, eng, ref))
    assert out == jout == rout
    assert _spec_counters(eng.stats) == _spec_counters(jeng.stats)
    s = eng.stats
    assert s.spec_rounds > 0
    assert s.spec_committed_tokens == s.decode_tokens - 4
    assert s.spec_accepted_tokens <= s.spec_draft_tokens
    for rs in eng.states.values():
        assert rs.token_rungs == [0] * len(rs.tokens)
    assert eng.decode_retraces_after_warmup == 0
    assert eng.chunk_retraces_after_warmup == 0
    assert eng.verify_retraces_after_warmup == 0
    assert eng.pool.num_free == 2
    # drafts replay the drafter's decode step: the step count holds them
    assert eng.decode_graphs.steps == [0, s.spec_draft_steps]
    assert eng.spec_decoder.verify_steps.steps == [s.spec_rounds]
    summ = s.summary()
    assert summ["spec_rounds"] == s.spec_rounds
    # the reference's summary: rates rounded as it rounds them
    assert summ["spec_accept_rate"] == round(
        s.spec_accepted_tokens / s.spec_draft_tokens, 4)
    assert {"spec_draft_p50_s", "spec_verify_p95_s",
            "spec_accepted_per_verify_p50"} <= set(summ)
    assert eng.spec_decoder.snapshot()["spec_gamma"] == 2


def test_gamma_switches_build_nothing_after_warmup(model):
    """Adaptive-range warmup builds every gamma's verify: switching the
    draft length mid-serve builds nothing and keeps the tokens of
    verifier-only decode; a gamma outside the built set raises."""
    _, tl = model["ladders"]["topk_shared"]
    prompts = _prompts(model["cfg"], 2, 12, step=3)
    spec = SpecConfig(gamma=2, drafter_rung=1, adaptive=True, gamma_min=1,
                      gamma_max=3, dwell=10_000)
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        spec=spec, **TRACE), ladder=tl, device="cpu")
    ref = Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
                 ladder=tl, device="cpu")
    vs = eng.spec_decoder.verify_steps
    assert vs.keys == [1, 2, 3] and vs.builds == 3
    assert eng.chunk_graphs.builds == 3       # dense rung 0; rung 1 two
    for b, g in ((0, 3), (1, 1)):
        eng.spec_decoder.set_gamma(g)
        got = eng.submit(prompts[b], 6)
        eng.run()
        want = ref.submit(prompts[b], 6)
        ref.run()
        assert got.tokens == want.tokens
    assert vs.steps[0] > 0 and vs.steps[2] > 0
    assert (eng.decode_retraces_after_warmup, eng.chunk_retraces_after_warmup,
            eng.verify_retraces_after_warmup) == (0, 0, 0)
    with pytest.raises(ValueError, match="gamma"):
        eng.spec_decoder.set_gamma(4)


def test_rung_switches_build_no_chunk_after_warmup(model):
    """Every rung's chunk step is built at warmup, one per distinct
    prefill phase policy; switching rungs between prefill chunks builds
    nothing."""
    _, tl = model["ladders"]["pallas"]
    eng = Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
                 ladder=tl, device="cpu")
    assert eng.chunk_retraces_after_warmup is None
    eng.warmup()
    ch = eng.chunk_graphs
    assert ch.builds == len(ch) == 3
    for p in _prompts(model["cfg"], 3, 20, step=1):
        eng.submit(p, 3)
    while eng.scheduler.has_work():
        if eng.step() == "prefill":
            eng.set_rung(1 - eng.rung)
    assert eng.chunk_retraces_after_warmup == 0
    assert eng.decode_retraces_after_warmup == 0
    assert sum(ch.steps) == eng.stats.prefill_chunks
    assert sum(1 for n in ch.steps if n) >= 2


def test_spec_eos_and_budget_truncate_like_the_verifier(model):
    """An EOS inside a committed window stops the request at the token
    verifier-only decode stops at; a budget shorter than gamma + 1 cuts
    the commit.  Both as in the JAX spec engine."""
    jl, tl = model["ladders"]["topk_shared"]
    prompt = _prompts(model["cfg"], 1, 12, step=11)[0]
    ref = Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
                 ladder=tl, device="cpu")
    ref.submit(prompt, 8)
    full = ref.run()[0]
    k = next(i for i in range(2, len(full)) if full[i] not in full[:i])
    outs = {}
    for name, eng in (
            ("port", Engine(model["params"], model["cfg"], EngineConfig(
                spec=SpecConfig(gamma=3, drafter_rung=1), **TRACE),
                ladder=tl, device="cpu")),
            ("jax", JEngine(model["jparams"], model["jcfg"], JEngineConfig(
                spec=JSpecConfig(gamma=3, drafter_rung=1), **TRACE),
                ladder=jl))):
        eos = eng.submit(prompt, 8, eos_id=full[k])
        budget = eng.submit(prompt, 2)
        eng.run()
        assert eos.finish_reason.value == "eos"
        assert budget.finish_reason.value == "max_tokens"
        assert eng.pool.num_free == 2
        outs[name] = (eos.tokens, budget.tokens, _spec_counters(eng.stats))
    assert outs["port"][0] == full[:k + 1]
    assert outs["port"][1] == full[:2]
    assert outs["port"] == outs["jax"]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(gamma=2, drafter_rung=0), dict(gamma=0), dict(verifier_rung=-1),
    dict(gamma=5, adaptive=True, gamma_max=4), dict(adapt_drafter=True)])
def test_spec_config_validation_equals_jax(kw):
    msgs = []
    for cls in (SpecConfig, JSpecConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_spec_config_gammas():
    assert list(SpecConfig(gamma=3).gammas()) == [3]
    a = SpecConfig(gamma=2, adaptive=True, gamma_min=1, gamma_max=5)
    assert list(a.gammas()) == [1, 2, 3, 4, 5] and a.max_gamma == 5
    assert SpecConfig(gamma=3).max_gamma == 3


@pytest.mark.parametrize("case", ["no_ladder", "slo", "drafter",
                                  "initial_rung", "sparse_verifier"])
def test_spec_engine_validation_equals_jax(model, case):
    """The engine's spec checks raise the reference's messages."""
    budgets = (0.0, 0.5, 0.75) if case == "sparse_verifier" else (0.0, 0.5)
    jl = JLadder.uniform(model["jparams"], model["jcfg"], budgets)
    tl = PolicyLadder.uniform(model["params"], model["cfg"], budgets)
    kw, spec = {}, dict(gamma=2, drafter_rung=1)
    if case == "slo":
        kw["slo"] = "slo"
    elif case == "drafter":
        spec["drafter_rung"] = 5
    elif case == "initial_rung":
        kw["initial_rung"] = 1
    elif case == "sparse_verifier":
        kw["initial_rung"] = 1
        spec = dict(gamma=2, drafter_rung=2, verifier_rung=1)
    msgs = []
    for eng, ecfg, scfg, slo, ladder, extra in (
            (JEngine, JEngineConfig, JSpecConfig, JSLOConfig, jl, {}),
            (Engine, EngineConfig, SpecConfig, SLOConfig, tl,
             {"device": "cpu"})):
        ekw = dict(kw)
        if case == "slo":
            ekw["slo"] = slo(tpot_p95=1.0)
        c = ecfg(max_slots=2, max_len=32, spec=scfg(**spec), **ekw)
        with pytest.raises(ValueError) as e:
            eng(model["jparams"] if eng is JEngine else model["params"],
                model["jcfg"] if eng is JEngine else model["cfg"], c,
                ladder=None if case == "no_ladder" else ladder, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_engine_spec_needs_a_spec_config():
    with pytest.raises(TypeError, match="SpecConfig"):
        EngineConfig(spec=object())
    assert EngineConfig(spec=SpecConfig()).spec == SpecConfig()


# ---------------------------------------------------------------------------
# the acceptance controller against the JAX one
# ---------------------------------------------------------------------------

def _run_ctrl(ctrl, fracs):
    return ([ctrl.update(f) for f in fracs], ctrl.transitions,
            ctrl.accept_ewma, ctrl.snapshot())


@settings(max_examples=200, deadline=None)
@given(fracs=st.lists(st.floats(0.0, 1.0, allow_nan=False), min_size=1,
                      max_size=80), data=st.data())
def test_spec_controller_equals_jax(fracs, data):
    gmin = data.draw(st.integers(1, 3))
    gmax = data.draw(st.integers(gmin, 6))
    dmin = data.draw(st.integers(1, 3))
    dmax = data.draw(st.integers(dmin, 5))
    kw = dict(drafter_rung=data.draw(st.integers(dmin, dmax)),
              drafter_min=dmin, drafter_max=dmax,
              adapt_drafter=data.draw(st.booleans()),
              alpha=data.draw(st.floats(0.05, 1.0)),
              dwell=data.draw(st.integers(1, 10)))
    lower = data.draw(st.floats(0.0, 0.6))
    kw.update(lower_at=lower, raise_at=data.draw(st.floats(lower + 0.01,
                                                           1.0)))
    gamma = data.draw(st.integers(gmin, gmax))
    got = _run_ctrl(SpecController(gamma, gmin, gmax, **kw), fracs)
    want = _run_ctrl(JSpecController(gamma, gmin, gmax, **kw), fracs)
    assert got == want


@pytest.mark.parametrize("args,kw", [
    ((3, 1, 2), dict(drafter_rung=1, drafter_min=1, drafter_max=1)),
    ((2, 1, 4), dict(drafter_rung=3, drafter_min=1, drafter_max=2)),
    ((2, 1, 4), dict(drafter_rung=1, drafter_min=1, drafter_max=1,
                     lower_at=0.9, raise_at=0.5)),
    ((2, 1, 4), dict(drafter_rung=1, drafter_min=1, drafter_max=1,
                     alpha=0.0)),
    ((2, 1, 4), dict(drafter_rung=1, drafter_min=1, drafter_max=1,
                     dwell=0))])
def test_spec_controller_validation_equals_jax(args, kw):
    msgs = []
    for cls in (SpecController, JSpecController):
        with pytest.raises(ValueError) as e:
            cls(*args, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_serves_spec(model, tmp_path, capsys):
    jl, _ = model["ladders"]["topk_shared"]
    path = str(tmp_path / "ladder.npz")
    jl.save(path)
    argv = ["--reduced", "--device", "cpu", "--ladder", path, "--batch",
            "2", "--prompt-len", "10", "--gen", "5"]
    plain = serve.main(argv)
    capsys.readouterr()
    out = serve.main(argv + ["--spec-gamma", "2", "--spec-drafter", "1"])
    text = capsys.readouterr().out
    assert "spec: {'spec_gamma': 2, 'spec_drafter_rung': 1" in text
    assert "retraces after warmup: decode 0 verify 0" in text
    assert out == plain
    with pytest.raises(SystemExit, match="out of range"):
        serve.main(argv + ["--spec-gamma", "2", "--spec-drafter", "2"])


@pytest.mark.parametrize("argv,match", [
    (["--spec-gamma", "2"], "needs --ladder"),
    (["--ladder", "x.npz", "--spec-gamma", "2", "--slo-tpot-p95", "0.1"],
     "conflicts"),
    (["--spec-drafter", "2"], "need --spec-gamma"),
    (["--spec-adaptive"], "need --spec-gamma")])
def test_serve_cli_spec_flag_validation(argv, match):
    args = serve.build_parser().parse_args(argv)
    with pytest.raises(SystemExit, match=match):
        serve.validate_args(args)
