"""The port's prefix cache against the JAX package's, on the reduced
llama31_8b (f32) with JAX-initialised weights.

Each case of ``tests/test_prefix_cache.py`` has a counterpart here that
runs the JAX function and the port's on the same inputs: the radix tree
on the same operation sequences (match and evict results equal), the
pool's segment layer on the same pool contents (segments and pools
equal, across the two packages' identical cache layouts), and the
engines on the same prompts (greedy tokens, prefix counters and the
cache's snapshot exactly equal, for plain, mixed-ladder and spec
engines).  Every guard refuses where the reference refuses, with a
``ValueError`` of the same text.  The pool tensors keep their addresses
through every hit and publish (the captured graphs on the card hold
them), and no step is built after warmup."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.data import DataConfig, SyntheticLM
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import RadixTree as JRadixTree
from repro.serving import SlotKVPool as JPool
from repro.serving import SpecConfig as JSpecConfig
from repro.sparsity import PolicyLadder as JLadder
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.serving import (Engine, EngineConfig, PrefixCache,
                                 RadixTree, SlotKVPool, SpecConfig)
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=reduced(get_config("llama31_8b")),
                params=P.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams)))


def _prompts(cfg, n, seq, step=0):
    return np.asarray(SyntheticLM(
        DataConfig(cfg.vocab_size, seq, n)).batch(step))


def _tladder(jl):
    """The port's copy of a JAX ladder: same policies and sp trees."""
    return PolicyLadder(
        budgets=jl.budgets,
        policies=tuple(SparsityPolicy.from_dict(p.to_dict())
                       for p in jl.policies),
        sps=tuple(P.from_numpy(jax.tree_util.tree_map(np.asarray, sp))
                  for sp in jl.sps))


def _pool_leaves(pool):
    return [e["self"][k] for g in pool.caches for e in g for k in ("k", "v")]


def _ptrs(pool):
    return [t.data_ptr() for t in _pool_leaves(pool)]


# ---------------------------------------------------------------------------
# radix tree: the same operations on both trees
# ---------------------------------------------------------------------------

def _res(node_n):
    node, n = node_n
    return (None if node is None else (node.payload, node.end), n)


def test_radix_insert_match_and_limit_clamp():
    trees = (JRadixTree(), RadixTree())
    for t in trees:
        t.insert((1, 2, 3, 4), "seg4", 8)
    for q, lim in (((1, 2, 3, 4), 3), ((1, 2, 3, 9), 3), ((7, 8), 1),
                   ((1,), 0)):
        got = [_res(t.match(q, limit=lim)) for t in trees]
        assert got[0] == got[1]
    node, n = trees[1].match((1, 2, 3, 4), limit=3)
    assert n == 3 and node.payload == "seg4" and node.end >= n
    assert trees[1].match((7, 8), limit=1) == (None, 0)
    assert trees[1].match((1,), limit=0) == (None, 0)


def test_radix_mid_edge_source_and_split_insert():
    trees = (JRadixTree(), RadixTree())
    for t in trees:
        t.insert((5, 5, 1, 1), "a", 4)
    assert _res(trees[0].match((5, 5, 2, 2), limit=3)) == \
        _res(trees[1].match((5, 5, 2, 2), limit=3)) == (("a", 4), 2)
    for t in trees:
        t.insert((5, 5, 2, 2), "b", 4)
    for q, lim in (((5, 5, 1, 1, 9), 4), ((5, 5, 2, 2, 9), 4),
                   ((5, 5, 9), 2)):
        assert _res(trees[0].match(q, limit=lim)) == \
            _res(trees[1].match(q, limit=lim))
    assert trees[1].match((5, 5, 1, 1, 9), limit=4)[0].payload == "a"
    assert trees[1].match((5, 5, 2, 2, 9), limit=4)[0].payload == "b"
    for t in trees:
        assert t.num_payloads == 2 and t.total_size == 8


def test_radix_eviction_lru_leaves_only_and_pins():
    out = []
    for t in (JRadixTree(), RadixTree()):
        a = t.insert((1, 1, 1), "a", 4)
        b = t.insert((1, 1, 1, 2, 2), "b", 8)
        c = t.insert((3, 3), "c", 4)
        t.match((3, 3), limit=2)
        ev1 = t.evict(budget=8)
        assert [n.end for n in ev1] == [b.end] and t.total_size == 8
        t.pin(c)
        ev2 = t.evict(budget=0)
        assert c not in ev2 and c.payload is not None
        t.unpin(c)
        ev3 = t.evict(budget=0)
        assert ev3 == [c] and t.total_size == 0 and a.payload is None
        with pytest.raises(ValueError, match="below zero"):
            t.unpin(c)
        out.append([[n.path for n in ev] for ev in (ev1, ev2, ev3)])
    assert out[0] == out[1]


_TOKENS = st.lists(st.integers(0, 3), min_size=1, max_size=6)
_OPS = st.lists(st.one_of(
    st.tuples(st.just("insert"), _TOKENS),
    st.tuples(st.just("match"), _TOKENS),
    st.tuples(st.just("pin"), _TOKENS),
    st.tuples(st.just("evict"), st.integers(0, 30)),
), max_size=40)


@given(_OPS)
@settings(max_examples=60, deadline=None)
def test_radix_hypothesis_property(seq):
    """Random insert/match/pin/evict sequences on both trees: every match
    and every eviction equal the JAX tree's, and both hold the
    reference's brute-force invariants (longest-prefix match, refcounts
    never negative, evicted segments never pinned, exact sizes)."""
    jt, t = JRadixTree(), RadixTree()
    live = {}                                 # path -> size
    pinned = {}                               # path -> (jax node, node)
    for op, arg in seq:
        if op == "insert":
            path = tuple(arg)
            for tree in (jt, t):
                tree.insert(path, f"seg{path}", len(path))
            live.setdefault(path, len(path))
        elif op == "match":
            q = tuple(arg)
            limit = len(q) - 1
            jm, m = jt.match(q, limit=limit), t.match(q, limit=limit)
            assert _res(jm) == _res(m)
            node, n = m
            want = 0
            for path in live:
                lcp = 0
                while lcp < min(len(path), len(q)) and path[lcp] == q[lcp]:
                    lcp += 1
                want = max(want, min(lcp, limit))
            assert n == want, (q, n, want, sorted(live))
            if n:
                assert node.payload is not None and node.end >= n
                assert node.path[:n] == q[:n]
        elif op == "pin":
            path = tuple(arg)
            jnode, jn = jt.match(path, limit=len(path))
            node, n = t.match(path, limit=len(path))
            assert (jn, jnode is None) == (n, node is None)
            if node is not None and path not in pinned:
                jt.pin(jnode)
                t.pin(node)
                pinned[path] = (jnode, node)
        else:
            before = {n.path for n in t.payload_nodes()}
            jev, ev = jt.evict(arg), t.evict(arg)
            assert [n.path for n in jev] == [n.path for n in ev]
            for n in ev:
                assert n.refcount == 0
                assert n not in [pn for _, pn in pinned.values()]
            for path in before - {n.path for n in t.payload_nodes()}:
                live.pop(path, None)
        assert t.total_size == jt.total_size == sum(live.values())
        assert t.total_size == sum(n.size for n in t.payload_nodes())
        assert all(n.refcount >= 0 for n in t.payload_nodes())
    for jnode, node in pinned.values():
        jt.unpin(jnode)
        t.unpin(node)
        assert node.refcount >= 0


# ---------------------------------------------------------------------------
# pool segment layer
# ---------------------------------------------------------------------------

def _fill_same(jpool, pool, fn):
    """Give both pools the same contents (the port's in place)."""
    jpool.caches = jax.tree_util.tree_map(fn, jpool.caches)
    for t, a in zip(_pool_leaves(pool), jax.tree_util.tree_leaves(
            jpool.caches)):
        t.copy_(torch.from_numpy(np.array(a, np.float32)))


def test_pool_extract_write_roundtrip(model):
    """A slot's prefix survives extract -> write into another slot
    bit-exactly, equal to the JAX pool's segment and pool, with the
    leaf shapes of ``prefix_segment_schema`` and the pool tensors at
    their addresses."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jpool = JPool(jcfg, max_slots=3, max_len=16)
    pool = SlotKVPool(cfg, 3, 16, device="cpu")
    s0, s1 = pool.alloc(), pool.alloc()
    assert (jpool.alloc(), jpool.alloc()) == (s0, s1)
    _fill_same(jpool, pool, lambda leaf: jnp.arange(
        leaf.size, dtype=jnp.float32).reshape(leaf.shape).astype(leaf.dtype))
    ptrs = _ptrs(pool)
    jseg, seg = jpool.extract_prefix(s0, 8), pool.extract_prefix(s0, 8)
    schema = [e["self"][k].shape for g in api.prefix_segment_schema(cfg, 8)
              for e in g for k in ("k", "v")]
    got = [e["self"][k] for g in seg for e in g for k in ("k", "v")]
    assert [tuple(t.shape) for t in got] == [tuple(s) for s in schema]
    for t, a in zip(got, jax.tree_util.tree_leaves(jseg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    before = [t.clone() for t in _pool_leaves(pool)]
    jpool.write_prefix(jseg, s1)
    pool.write_prefix(seg, s1)
    for t, a in zip(_pool_leaves(pool), jax.tree_util.tree_leaves(
            jpool.caches)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    for name, new, old, s in zip(("k", "v"), _pool_leaves(pool), before, got):
        t_ax = 4 if name == "k" else 3
        new, old, s = (x.movedim((1, t_ax), (0, 1)) for x in (new, old, s))
        assert torch.equal(new[s1, :8], s[0, :8])
        assert torch.equal(new[s1, 8:], old[s1, 8:])          # untouched
        assert torch.equal(new[s0], old[s0])                  # donor intact
    assert _ptrs(pool) == ptrs
    for bad in ((s0, 99), (2, 4)):                # too long; unallocated
        with pytest.raises(ValueError):
            jpool.extract_prefix(*bad)
        with pytest.raises(ValueError):
            pool.extract_prefix(*bad)


def test_pool_free_set_stays_consistent(model):
    """The same alloc/free/commit sequence on both pools gives the same
    slots and lengths, the free set mirrors the free list, and the state
    guards fire on both."""
    jpool = JPool(model["jcfg"], max_slots=5, max_len=16)
    pool = SlotKVPool(model["cfg"], 5, 16, device="cpu")

    def consistent():
        assert pool._free_set == set(pool._free)
        assert len(pool._free_set) == len(pool._free)
        assert pool._free == jpool._free
        np.testing.assert_array_equal(pool.lengths, jpool.lengths)

    rng = np.random.default_rng(0)
    held = []
    consistent()
    for _ in range(100):
        if held and rng.random() < 0.45:
            slot = held.pop(rng.integers(len(held)))
            pool.free(slot)
            jpool.free(slot)
        elif pool.num_free:
            slot = pool.alloc()
            assert jpool.alloc() == slot
            n = int(rng.integers(0, 4))
            pool.commit(slot, n)
            jpool.commit(slot, n)
            held.append(slot)
        consistent()
    for slot in held:
        pool.free(slot)
        jpool.free(slot)
    consistent()
    slot = pool.alloc()
    pool.free(slot)
    jslot = jpool.alloc()
    jpool.free(jslot)
    for p in (pool, jpool):
        with pytest.raises(ValueError):
            p.free(slot)
        with pytest.raises(ValueError):
            p.commit(slot, 1)
    consistent()


def test_prefix_cache_rejects_sliced_layouts():
    """A pool whose layout cannot slice a prefix by position is refused
    with the reference's error: a stand-in, and the SSM pool of reduced
    mamba2_130m (conv windows and state, no time axis), in both
    packages."""
    fake = types.SimpleNamespace(can_cache_prefix=False)
    msgs = []
    for cls in (JPrefixCache, PrefixCache):
        with pytest.raises(ValueError, match="full-length self-attention") \
                as exc:
            cls(fake, chunk=8)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    pool = SlotKVPool(reduced(get_config("mamba2_130m")), 2, 16, device="cpu")
    assert not pool.can_cache_prefix
    with pytest.raises(ValueError, match="full-length self-attention") as exc:
        PrefixCache(pool, chunk=8)
    assert str(exc.value) == msgs[0]
    for kw in (dict(chunk=0), dict(chunk=8, capacity_tokens=-1)):
        for cls in (JPrefixCache, PrefixCache):
            with pytest.raises(ValueError):
                cls(types.SimpleNamespace(can_cache_prefix=True), **kw)


# ---------------------------------------------------------------------------
# engine-level parity: hits equal cold prefill, and the JAX engine
# ---------------------------------------------------------------------------

def _run_serialized(eng, prompts, gen):
    out = []
    for p in prompts:
        rs = eng.submit(p, gen)
        eng.run()
        out.append(rs.tokens)
    return out


_PREFIX_STATS = ("prefix_lookups", "prefix_hits", "prefix_tokens_saved",
                 "prefix_evicted_segments")


def _prefix_stats(stats):
    return ({k: getattr(stats, k) for k in _PREFIX_STATS},
            list(stats.prefix_hit_len))


def _pair(model, ecfg_kw, policy=None, sp=None, jladder=None):
    """(JAX engine, port engine) on the same weights and config."""
    jeng = JEngine(model["jparams"], model["jcfg"], JEngineConfig(
        policy=policy, **ecfg_kw), sp, ladder=jladder)
    teng = Engine(model["params"], model["cfg"], EngineConfig(
        policy=None if policy is None else SparsityPolicy.from_dict(
            policy.to_dict()), **ecfg_kw),
        None if sp is None else P.from_numpy(jax.tree_util.tree_map(
            np.asarray, sp)),
        device="cpu", ladder=None if jladder is None else _tladder(jladder))
    return jeng, teng


def test_engine_hit_parity_and_stats(model):
    """Cache hits give the cold engine's tokens, and the port's warm
    engine gives the JAX warm engine's tokens, prefix counters and
    snapshot: two mid-edge hits at the 16-token shared prefix and one
    repeat clamped to P - 1 = 19 (a suffix chunk at an offset that is
    not a chunk multiple)."""
    cfg = model["jcfg"]
    shared = _prompts(cfg, 1, 16, step=5)[0]
    prompts = [np.concatenate([shared, np.full(4, 10 + i, np.int32)])
               for i in range(3)]
    prompts.append(prompts[0])
    kw = dict(max_slots=2, max_len=32, prefill_chunk=8)
    jcold, cold = _pair(model, kw)
    jwarm, warm = _pair(model, dict(kw, prefix_cache=True))
    ptrs = _ptrs(warm.pool)
    want = _run_serialized(jcold, prompts, 5)
    assert _run_serialized(jwarm, prompts, 5) == want
    assert _run_serialized(cold, prompts, 5) == want
    assert _run_serialized(warm, prompts, 5) == want
    assert _prefix_stats(warm.stats) == _prefix_stats(jwarm.stats)
    probe = np.concatenate([shared[:12], np.full(6, 99, np.int32)])
    for q in prompts + [probe]:
        assert warm.prefix_cache.lookup(q) == jwarm.prefix_cache.lookup(q)
    assert warm.prefix_cache.lookup(probe) == 12
    assert _prefix_stats(warm.stats) == _prefix_stats(jwarm.stats)
    s = warm.stats
    assert (s.prefix_lookups, s.prefix_hits) == (4, 3)
    assert s.prefix_tokens_saved == 16 + 16 + 19
    jsnap = jwarm.snapshot()
    snap = warm.prefix_cache.snapshot()
    assert snap == {k: jsnap[k] for k in snap}
    assert snap["prefix_hit_rate"] == 0.75 and snap["prefix_segments"] == 3
    assert warm.stats.summary()["prefix_hit_rate"] == 0.75
    assert warm.decode_retraces_after_warmup == 0
    assert warm.chunk_retraces_after_warmup == 0
    assert _ptrs(warm.pool) == ptrs


def test_engine_hit_parity_mixed_ladder_rung(model):
    """A pinned sparse rung with a mixed per-block decode policy: hits
    give the cold generation, and the port gives the JAX engine's."""
    jparams, cfg = model["jparams"], model["jcfg"]
    mixed = JPolicy.uniform(
        "topk_shared", k_max_frac=0.5, block_backends=((0, 1, "off"),),
        dense_phases=("prefill_dense", "prefill_sparse"))
    jl = JLadder(
        budgets=(0.0, 0.5),
        policies=(JPolicy.dense(
            dense_phases=("prefill_dense", "prefill_sparse")), mixed),
        sps=(jdefault_sp(jparams, cfg, keep_frac=1.0),
             jdefault_sp(jparams, cfg, keep_frac=0.5)))
    base = _prompts(cfg, 2, 20, step=9)
    shared = base[0, :14]
    prompts = [np.concatenate([shared, base[i, 14:18]]) for i in range(2)]
    outs, stats = [], []
    for prefix in (False, True):
        jeng, teng = _pair(model, dict(max_slots=2, max_len=32,
                                       prefill_chunk=8, initial_rung=1,
                                       prefix_cache=prefix), jladder=jl)
        outs += [_run_serialized(jeng, prompts, 5),
                 _run_serialized(teng, prompts, 5)]
        stats.append((_prefix_stats(jeng.stats), _prefix_stats(teng.stats)))
    assert all(o == outs[0] for o in outs)
    assert stats[1][0] == stats[1][1] and stats[1][1][0]["prefix_hits"] == 1


def test_engine_hit_parity_under_spec_decode(model):
    """Speculative decoding over a prefix-cache engine: hits happen, the
    tokens equal the no-cache spec engine's and the JAX spec engine's,
    and no decode, chunk or verify step is built after warmup."""
    jl = JLadder.uniform(model["jparams"], model["jcfg"], (0.0, 0.5),
                         dense_phases=("prefill_dense", "prefill_sparse"))
    base = _prompts(model["jcfg"], 3, 20, step=13)
    shared = base[0, :12]
    prompts = [np.concatenate([shared, base[i, 12:16]]) for i in range(3)]
    kw = dict(max_slots=2, max_len=32, prefill_chunk=8)
    jeng = JEngine(model["jparams"], model["jcfg"], JEngineConfig(
        spec=JSpecConfig(gamma=2, drafter_rung=1), prefix_cache=True, **kw),
        ladder=jl)
    outs = []
    for eng in [jeng] + [Engine(model["params"], model["cfg"], EngineConfig(
            spec=SpecConfig(gamma=2, drafter_rung=1), prefix_cache=prefix,
            **kw), device="cpu", ladder=_tladder(jl))
            for prefix in (False, True)]:
        for p in prompts:
            eng.submit(p, 6)
        got = eng.run()
        outs.append([got[i] for i in range(3)])
    warm = eng
    assert outs[0] == outs[1] == outs[2]
    assert warm.stats.prefix_hits >= 1
    assert _prefix_stats(warm.stats) == _prefix_stats(jeng.stats)
    assert warm.decode_retraces_after_warmup == 0
    assert warm.chunk_retraces_after_warmup == 0
    assert warm.verify_retraces_after_warmup == 0


def test_engine_eviction_respects_budget(model):
    prompts = [_prompts(model["jcfg"], 1, 12, step=20 + i)[0]
               for i in range(4)]
    jeng, eng = _pair(model, dict(max_slots=2, max_len=24, prefill_chunk=8,
                                  prefix_cache=True,
                                  prefix_cache_tokens=32))
    assert _run_serialized(eng, prompts, 3) == \
        _run_serialized(jeng, prompts, 3)
    # each 12-token prompt stores a 16-token (chunk-quantized) segment
    assert eng.prefix_cache.cached_tokens <= 32
    assert eng.stats.prefix_evicted_segments >= 2
    assert eng.prefix_cache.num_segments <= 2
    assert _prefix_stats(eng.stats) == _prefix_stats(jeng.stats)
    assert eng.prefix_cache.snapshot() == jeng.prefix_cache.snapshot()


def test_suffix_chunk_after_a_hit_writes_only_its_window(model):
    """A hit at 19 (not a chunk multiple): the suffix chunk writes
    positions [19, 27) of its slot and nothing else — its 7 pad rows land
    past the prompt, inside the slack ``[max_len, pool_len - 1)``
    reserved for them, and the scratch position ``pool_len - 1`` is not
    reached.  Every position the chunk may not write holds a sentinel
    before the step (masked positions are only read with weight 0)."""
    cfg = model["cfg"]
    prompt = _prompts(model["jcfg"], 1, 20, step=5)[0]
    eng = Engine(model["params"], cfg, EngineConfig(
        max_slots=2, max_len=24, prefill_chunk=8, prefix_cache=True),
        device="cpu")
    eng.submit(prompt, 2)
    eng.run()
    rs = eng.submit(prompt, 2)
    eng._admit()
    assert rs.next_offset == 19 and eng.pool_len == 32
    sentinel = 12345.0
    for name, t in zip(("k", "v") * 4, _pool_leaves(eng.pool)):
        view = t.movedim((1, 4 if name == "k" else 3), (0, 1))
        view[rs.slot, 19:] = sentinel
        view[1 - rs.slot] = sentinel
    before = [t.clone() for t in _pool_leaves(eng.pool)]
    eng.step()
    assert rs.next_offset == 20 and rs.tokens
    for name, t, t0 in zip(("k", "v") * 4, _pool_leaves(eng.pool), before):
        view, view0 = (x.movedim((1, 4 if name == "k" else 3), (0, 1))
                       for x in (t, t0))
        assert torch.equal(view[:, :19], view0[:, :19])   # the copied prefix
        kept = (view == sentinel).reshape(view.shape[0], view.shape[1], -1)
        assert kept[1 - rs.slot].all()                    # other slot
        written = ~kept[rs.slot, 19:].all(-1)
        assert np.nonzero(written.numpy())[0].tolist() == list(range(8))
        assert kept[rs.slot, eng.pool_len - 1].all()


@pytest.mark.parametrize("case", ["whole", "budget", "shared_topk",
                                  "phase_split", "ladder_sparse_prefill"])
def test_prefix_cache_guards(model, case):
    """Every guard refuses where the reference refuses, with the same
    ``ValueError``."""
    jparams, jcfg = model["jparams"], model["jcfg"]
    jsp = jdefault_sp(jparams, jcfg, keep_frac=0.5)
    kw = dict(max_slots=2, max_len=24, prefill_chunk=8, prefix_cache=True)
    msgs = []
    if case in ("whole", "budget"):
        bad = (dict(prefill_strategy="whole") if case == "whole"
               else dict(prefix_cache_tokens=-1))
        for cls in (JEngineConfig, EngineConfig):
            with pytest.raises(ValueError) as exc:
                cls(**dict(kw, **bad))
            msgs.append(str(exc.value))
    elif case == "ladder_sparse_prefill":
        jl = JLadder.uniform(jparams, jcfg, (0.0, 0.5))
        for frac, ok in ((0.0, False), (1.0, True)):
            e = dict(kw, prefill_dense_frac=frac)
            if ok:
                JEngine(jparams, jcfg, JEngineConfig(**e), ladder=jl)
                Engine(model["params"], model["cfg"], EngineConfig(**e),
                       device="cpu", ladder=_tladder(jl))
                continue
            with pytest.raises(ValueError) as exc:
                JEngine(jparams, jcfg, JEngineConfig(**e), ladder=jl)
            msgs.append(str(exc.value))
            with pytest.raises(ValueError) as exc:
                Engine(model["params"], model["cfg"], EngineConfig(**e),
                       device="cpu", ladder=_tladder(jl))
            msgs.append(str(exc.value))
    else:
        pol, frac = ((JPolicy.uniform("topk_shared", k_max_frac=0.5,
                                      dense_phases=()), 0.0)
                     if case == "shared_topk"
                     else (JPolicy.uniform("mask"), 0.5))
        eng_kw = dict(kw, prefill_dense_frac=frac)
        with pytest.raises(ValueError) as exc:
            JEngine(jparams, jcfg, JEngineConfig(policy=pol, **eng_kw), jsp)
        msgs.append(str(exc.value))
        with pytest.raises(ValueError) as exc:
            Engine(model["params"], model["cfg"], EngineConfig(
                policy=SparsityPolicy.from_dict(pol.to_dict()), **eng_kw),
                P.from_numpy(jax.tree_util.tree_map(np.asarray, jsp)),
                device="cpu")
        msgs.append(str(exc.value))
        if case == "phase_split":
            # paper-exact mask everywhere is prefix-deterministic:
            # accepted by both
            jeng, eng = _pair(model, dict(kw, prefill_dense_frac=0.0),
                              policy=pol, sp=jsp)
            assert jeng.prefix_cache is not None
            assert eng.prefix_cache is not None
    assert len(msgs) == 2 and msgs[0] == msgs[1]
