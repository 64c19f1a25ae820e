"""The port's priority scheduling and KV preemption against the JAX
package's, on the reduced llama31_8b (f32) with JAX-initialised weights.

Each case of ``tests/test_preemption.py`` has a counterpart here that
runs the JAX function and the port's on the same inputs: the two
schedulers make the same decisions on the same traces (strict priority,
WFQ, ``QueueFull``, ``expire``, ``pick_victim``, resume order, and a
hypothesis property over random operation sequences); a preempted
request's tokens equal the uncontended run's and the JAX preempted
engine's, with the same preemption and resume counts, under a pinned
dense engine, a ``mask`` ladder rung and speculative decoding;
suspend/resume round-trips a slot bit-exactly, equal to the JAX pool's
segment, in bf16 and f32; queue-full and deadline expiry behave as the
JAX engine's; and the ``priority_aware`` controller holds the JAX
engine's escalations.  The pool tensors keep their addresses through
suspend and resume, and no step is built after warmup."""
import dataclasses

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
from repro.serving import Priority as JPriority
from repro.serving import QueueFull as JQueueFull
from repro.serving import Scheduler as JScheduler
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import SlotKVPool as JPool
from repro.serving import SLOConfig as JSLOConfig
from repro.serving import SpecConfig as JSpecConfig
from repro.serving import Status as JStatus
from repro.serving.request import Request as JRequest
from repro.serving.request import RequestState as JRequestState
from repro.sparsity import PolicyLadder as JLadder
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import params as P
from repro_torch.serving import (AdaptiveController, Engine, EngineConfig,
                                 Priority, QueueFull, Scheduler,
                                 SchedulerConfig, SlotKVPool, SLOConfig,
                                 SpecConfig, Status, SuspendedSlot)
from repro_torch.serving.request import Request, RequestState
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
    return PolicyLadder(
        budgets=jl.budgets,
        policies=tuple(SparsityPolicy.from_dict(p.to_dict())
                       for p in jl.policies),
        sps=tuple(P.from_numpy(jax.tree_util.tree_map(np.asarray, sp))
                  for sp in jl.sps))


def _pool_leaves(pool):
    return [e["self"][k] for g in pool.caches for e in g for k in ("k", "v")]


# ---------------------------------------------------------------------------
# the schedulers on the same traces
# ---------------------------------------------------------------------------

def _rs_pair(rid, priority=1, tenant="default", prompt_len=8, max_new=8,
             arrival=0.0, deadline=None):
    """The same request as a JAX and a port RequestState."""
    kw = dict(request_id=rid, prompt=np.zeros(prompt_len, np.int32),
              max_new_tokens=max_new, arrival_time=arrival, tenant=tenant,
              queue_deadline_s=deadline)
    return (JRequestState(JRequest(priority=JPriority(priority), **kw)),
            RequestState(Request(priority=Priority(priority), **kw)))


def _schedulers(**cfg):
    return (JScheduler(JSchedulerConfig(**cfg) if cfg else None),
            Scheduler(SchedulerConfig(**cfg) if cfg else None))


def _enqueue(scheds, *args, **kw):
    for s, rs in zip(scheds, _rs_pair(*args, **kw)):
        s.enqueue(rs)


def _pops(scheds, n):
    out = [[s.pop_admit().request.request_id for _ in range(n)]
           for s in scheds]
    assert out[0] == out[1]
    return out[1]


def _decode(scheds, rid, slot, priority, arrival=0.0):
    for s, rs in zip(scheds, _rs_pair(rid, priority, arrival=arrival)):
        rs.slot = slot
        rs.status = JStatus.DECODE if isinstance(s, JScheduler) \
            else Status.DECODE
        s.decoding[slot] = rs


def test_priority_names_and_values_equal_jax():
    assert [(p.name, int(p)) for p in Priority] == \
        [(p.name, int(p)) for p in JPriority]
    for name in ("interactive", "Best-Effort", " standard "):
        assert int(Priority.parse(name)) == int(JPriority.parse(name))
    for cls in (Priority, JPriority):
        with pytest.raises(ValueError, match="unknown priority"):
            cls.parse("urgent")


def test_strict_priority_across_classes():
    scheds = _schedulers()
    order = [2, 0, 1, 0, 2]
    for i, p in enumerate(order):
        _enqueue(scheds, i, p)
    assert [scheds[1].head_priority()] == [Priority.INTERACTIVE]
    popped = _pops(scheds, len(order))
    assert [order[i] for i in popped] == sorted(order)


def test_default_config_is_fifo():
    scheds = _schedulers()
    for i in range(5):
        _enqueue(scheds, i)
    assert _pops(scheds, 5) == [0, 1, 2, 3, 4]


def test_wfq_weights_share_admissions():
    scheds = _schedulers(tenant_weights=(("heavy", 2.0), ("light", 1.0)))
    rid = 0
    for _ in range(8):
        for tenant in ("heavy", "light"):
            _enqueue(scheds, rid, tenant=tenant)
            rid += 1
    first6 = _pops(scheds, 6)
    assert sum(1 for r in first6 if r % 2 == 0) == 4


def test_bounded_queue_raises_queue_full():
    scheds = _schedulers(max_queue=2)
    _enqueue(scheds, 0)
    _enqueue(scheds, 1)
    for s, err, rs in zip(scheds, (JQueueFull, QueueFull), _rs_pair(2)):
        assert not s.can_accept()
        with pytest.raises(err, match="capacity"):
            s.enqueue(rs)
        s.pop_admit()
        assert s.can_accept()
    with pytest.raises(ValueError):
        SchedulerConfig(max_queue=-1)
    with pytest.raises(ValueError, match="positive"):
        SchedulerConfig(tenant_weights=(("a", 0.0),))


def test_expire_sweeps_overdue_requests():
    scheds = _schedulers()
    _enqueue(scheds, 0, arrival=0.0, deadline=1.0)
    _enqueue(scheds, 1, arrival=0.0, deadline=10.0)
    _enqueue(scheds, 2, arrival=5.0, deadline=1.0)
    out = [{rs.request.request_id for rs in s.expire(now=4.0)}
           for s in scheds]
    assert out[0] == out[1] == {0}
    assert [s.queue_depth for s in scheds] == [2, 2]


def test_pick_victim_least_important_youngest():
    scheds = _schedulers(preemption=True)
    for rid, (p, t) in enumerate([(1, 0.0), (2, 1.0), (2, 2.0)]):
        _decode(scheds, rid, rid, p, arrival=t)
    victims = [s.pick_victim(Priority.INTERACTIVE) for s in scheds]
    assert [v.request.request_id for v in victims] == [2, 2]
    assert [s.pick_victim(Priority.BEST_EFFORT) for s in scheds] == \
        [None, None]
    for s, v in zip(scheds, victims):
        s.suspend(v)
    assert victims[1].status is Status.SUSPENDED
    assert [s.pick_victim(Priority.INTERACTIVE).request.request_id
            for s in scheds] == [1, 1]
    with pytest.raises(ValueError, match="not decoding"):
        scheds[1].suspend(victims[1])


def test_resume_outranks_by_class_then_suspend_order():
    scheds = _schedulers(preemption=True)
    for rid, p in enumerate([2, 1, 2]):
        _decode(scheds, rid, rid, p)
        for s in scheds:
            s.suspend(s.decoding[rid])
    assert [[s.pop_resume().request.request_id for _ in range(3)]
            for s in scheds] == [[1, 0, 2]] * 2
    assert not scheds[1].has_work()
    with pytest.raises(IndexError):
        scheds[1].pop_resume()


_OP = st.one_of(
    st.tuples(st.just("enqueue"), st.integers(0, 2),
              st.sampled_from(["a", "b", "c"]), st.integers(1, 40),
              st.sampled_from([None, 0.5, 3.0])),
    st.tuples(st.just("admit")), st.tuples(st.just("expire")),
    st.tuples(st.just("preempt"), st.integers(0, 2)),
    st.tuples(st.just("resume")), st.tuples(st.just("finish")))


@settings(max_examples=100, deadline=None)
@given(ops=st.lists(_OP, max_size=60),
       weights=st.sampled_from([(), (("a", 2.0), ("b", 0.5))]),
       max_queue=st.integers(0, 6))
def test_scheduler_decisions_equal_jax(ops, weights, max_queue):
    """Random admission traces on a 3-slot pool: both schedulers admit,
    expire, pick victims, resume and refuse the same requests in the
    same order, and agree on depth, head class and acceptance."""
    scheds = _schedulers(max_queue=max_queue, preemption=True,
                         tenant_weights=weights)
    free = [[0, 1, 2], [0, 1, 2]]
    rid, now = 0, 0.0
    log = [[], []]
    for op in ops:
        now += 1.0
        for k, s in enumerate(scheds):
            if op[0] == "enqueue":
                _, pri, tenant, plen, dl = op
                rs = _rs_pair(rid, pri, tenant, plen, arrival=now,
                              deadline=dl)[k]
                if s.can_accept():
                    s.enqueue(rs)
                    log[k].append(("q", rid))
                else:
                    log[k].append(("full", rid))
            elif op[0] == "admit" and s.queue_depth and free[k]:
                rs = s.pop_admit()
                rs.slot = free[k].pop()
                s.prefilling.append(rs)
                s.to_decode(rs)
                log[k].append(("admit", rs.request.request_id, rs.slot))
            elif op[0] == "expire":
                log[k].append(("expire", sorted(
                    r.request.request_id for r in s.expire(now - 2.0))))
            elif op[0] == "preempt":
                v = s.pick_victim(op[1])
                if v is not None:
                    free[k].append(v.slot)
                    s.suspend(v)
                    log[k].append(("preempt", v.request.request_id))
            elif op[0] == "resume" and s.suspended and free[k]:
                rs = s.pop_resume()
                rs.slot = free[k].pop()
                s.decoding[rs.slot] = rs
                log[k].append(("resume", rs.request.request_id, rs.slot))
            elif op[0] == "finish" and s.decoding:
                rs = s.decoding[min(s.decoding)]
                free[k].append(rs.slot)
                s.finish(rs)
                log[k].append(("finish", rs.request.request_id))
            hp = s.head_priority()
            log[k].append((s.queue_depth, None if hp is None else int(hp),
                           s.can_accept(), s.has_work(),
                           sorted(r.request.request_id for r in s.queued())))
        rid += 1
        assert log[0] == log[1]


# ---------------------------------------------------------------------------
# preempt -> resume bit-identity, against the JAX engine
# ---------------------------------------------------------------------------

def _engine(model, jax_side, max_slots, ladder, spec, initial_rung,
            scheduler=None):
    kw = dict(max_slots=max_slots, max_len=32, prefill_chunk=8,
              initial_rung=initial_rung)
    if jax_side:
        return JEngine(model["jparams"], model["jcfg"], JEngineConfig(
            spec=None if spec is None else JSpecConfig(**spec),
            scheduler=None if scheduler is None
            else JSchedulerConfig(**scheduler), **kw), None, ladder=ladder)
    return Engine(model["params"], model["cfg"], EngineConfig(
        spec=None if spec is None else SpecConfig(**spec),
        scheduler=None if scheduler is None
        else SchedulerConfig(**scheduler), **kw),
        device="cpu", ladder=None if ladder is None else _tladder(ladder))


def _uncontended(eng, prompts, gens):
    for b, g in enumerate(gens):
        eng.submit(prompts[b], g)
    return eng.run()


def _preempted(eng, prompts, gens, interactive):
    """Two best-effort requests fill the 2-slot pool and decode a few
    tokens, then an interactive arrival forces a preemption."""
    eng.submit(prompts[0], gens[0], priority="best-effort", tenant="batch")
    eng.submit(prompts[1], gens[1], priority="best-effort", tenant="batch")
    for _ in range(64):
        eng.step()
        if (len(eng.scheduler.decoding) == 2
                and all(len(rs.tokens) >= 2
                        for rs in eng.scheduler.decoding.values())):
            break
    else:
        pytest.fail("bulk requests never reached steady decode")
    eng.submit(prompts[2], gens[2], priority=interactive, tenant="chat")
    return eng.run()


def _assert_preempt_parity(model, ladder=None, spec=None, initial_rung=0):
    prompts = _prompts(model["jcfg"], 3, 12, step=5)
    gens = [16, 16, 4]
    ref = _uncontended(_engine(model, False, 3, ladder, spec, initial_rung),
                       prompts, gens)
    engines = [_engine(model, side, 2, ladder, spec, initial_rung,
                       dict(preemption=True)) for side in (True, False)]
    jeng, eng = engines
    ptrs = [t.data_ptr() for t in _pool_leaves(eng.pool)]
    jout = _preempted(jeng, prompts, gens, JPriority.INTERACTIVE)
    out = _preempted(eng, prompts, gens, Priority.INTERACTIVE)
    for rid in range(3):
        assert out[rid] == ref[rid], \
            f"request {rid} diverged after preemption"
        assert out[rid] == jout[rid]
    assert eng.stats.preemptions >= 1
    assert (eng.stats.preemptions, eng.stats.resumes) == \
        (jeng.stats.preemptions, jeng.stats.resumes)
    assert eng.stats.resumes == eng.stats.preemptions
    assert [rs.preemptions for rs in eng.states.values()] == \
        [rs.preemptions for rs in jeng.states.values()]
    assert all(rs.suspended is None for rs in eng.states.values())
    assert eng.decode_retraces_after_warmup == 0
    assert eng.chunk_retraces_after_warmup == 0
    if spec is not None:
        assert eng.verify_retraces_after_warmup == 0
    assert [t.data_ptr() for t in _pool_leaves(eng.pool)] == ptrs
    s = eng.stats.summary()
    assert s["preemptions"] == s["resumes"] == eng.stats.preemptions
    assert s["preempted_p50_s"] >= 0 and s["queue_wait_p95_s"] >= 0


def test_preempt_resume_bit_identity_pinned(model):
    _assert_preempt_parity(model)


def test_preempt_resume_bit_identity_ladder(model):
    jl = JLadder.uniform(model["jparams"], model["jcfg"], (0.0, 0.5),
                         backend="mask")
    _assert_preempt_parity(model, ladder=jl, initial_rung=1)


def test_preempt_resume_bit_identity_spec(model):
    jl = JLadder.uniform(model["jparams"], model["jcfg"], (0.0, 0.5))
    _assert_preempt_parity(model, ladder=jl,
                           spec=dict(gamma=2, drafter_rung=1))


def test_suspend_at_uncommitted_boundary_rejected(model):
    """_preempt refuses to suspend a slot whose pool length disagrees
    with the request's committed position (a torn commit), with the JAX
    engine's error."""
    prompts = _prompts(model["jcfg"], 2, 12)
    msgs = []
    for side in (True, False):
        eng = _engine(model, side, 1, None, None, 0, dict(preemption=True))
        eng.submit(prompts[0], 6, priority="best-effort")
        for _ in range(32):
            eng.step()
            if eng.scheduler.decoding:
                break
        victim = next(iter(eng.scheduler.decoding.values()))
        eng.pool.lengths[victim.slot] += 1
        with pytest.raises(RuntimeError, match="committed boundary") as exc:
            eng._preempt(victim)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# segment round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_suspend_resume_roundtrip_bit_exact(dtype):
    """suspend() -> resume() into another slot restores the live prefix
    bit-exactly, keeps every leaf's dtype, and gives the JAX pool's
    segment on the same contents; the segment lives in host memory and
    the pool tensors keep their addresses."""
    jcfg = dataclasses.replace(jreduced(jget_config("llama31_8b")),
                               dtype=dtype)
    cfg = dataclasses.replace(reduced(get_config("llama31_8b")), dtype=dtype)
    jpool = JPool(jcfg, max_slots=2, max_len=16)
    pool = SlotKVPool(cfg, 2, 16, device="cpu")
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(leaf.shape).astype(np.float32)
            for leaf in jax.tree_util.tree_leaves(jpool.caches)]
    jpool.caches = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jpool.caches),
        [jnp.asarray(v, jnp.dtype(dtype)) for v in vals])
    for t, v in zip(_pool_leaves(pool), vals):
        t.copy_(torch.from_numpy(v))
    ptrs = [t.data_ptr() for t in _pool_leaves(pool)]
    src = pool.alloc()
    assert jpool.alloc() == src
    pool.lengths[src] = jpool.lengths[src] = 11   # not a quantum multiple
    seg, jseg = pool.suspend(src, quantum=4), jpool.suspend(src, quantum=4)
    assert isinstance(seg, SuspendedSlot)
    assert (seg.length, seg.phys) == (jseg.length, jseg.phys) == (11, 12)
    for t, a in zip([e["self"][k] for g in seg.caches for e in g
                     for k in ("k", "v")],
                    jax.tree_util.tree_leaves(jseg.caches)):
        assert t.device.type == "cpu"
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))
    before = [t.clone() for t in _pool_leaves(pool)]
    dst = pool.alloc()
    pool.resume(seg, dst)
    assert pool.lengths[dst] == 11
    for name, t, b in zip(("k", "v") * 4, _pool_leaves(pool), before):
        assert t.dtype == getattr(torch, dtype)
        t_ax = 4 if name == "k" else 3
        got = t.movedim((1, t_ax), (0, 1))[dst, :12]
        want = b.movedim((1, t_ax), (0, 1))[src, :12]
        assert torch.equal(got, want), "segment round-trip not bit-exact"
    assert [t.data_ptr() for t in _pool_leaves(pool)] == ptrs
    with pytest.raises(TypeError, match="SuspendedSlot"):
        pool.resume(seg.caches, dst)
    with pytest.raises(ValueError, match="quantum"):
        pool.suspend(src, quantum=0)
    pool.lengths[src] = 0
    with pytest.raises(ValueError, match="no committed"):
        pool.suspend(src, quantum=4)


def test_mixed_dtype_leaves_roundtrip(model):
    """A cache tree with both bf16 and f32 leaves round-trips through
    extract_prefix/write_prefix with every leaf's dtype intact, as the
    JAX pool's does."""
    pool = SlotKVPool(model["cfg"], 2, 16, device="cpu")
    rng = np.random.default_rng(1)
    for i, g in enumerate(pool.caches):
        for e in g:
            for j, k in enumerate(("k", "v")):
                dt = torch.bfloat16 if (i + j) % 2 == 0 else torch.float32
                e["self"][k] = torch.from_numpy(rng.standard_normal(
                    e["self"][k].shape).astype(np.float32)).to(dt)
    dtypes = [t.dtype for t in _pool_leaves(pool)]
    assert len(set(dtypes)) == 2
    src = pool.alloc()
    pool.lengths[src] = 8
    seg = pool.suspend(src, quantum=8)
    assert [e["self"][k].dtype for g in seg.caches for e in g
            for k in ("k", "v")] == dtypes
    dst = pool.alloc()
    pool.resume(seg, dst)
    for name, t, dt in zip(("k", "v") * 4, _pool_leaves(pool), dtypes):
        assert t.dtype == dt
        t_ax = 4 if name == "k" else 3
        view = t.movedim((1, t_ax), (0, 1))
        assert torch.equal(view[dst, :8], view[src, :8])


# ---------------------------------------------------------------------------
# engine-level admission control, and the priority-aware controller
# ---------------------------------------------------------------------------

def test_engine_queue_full_and_deadline(model):
    """A full admission queue raises QueueFull with a retry estimate; a
    queued request whose deadline passes finishes EXPIRED without
    touching a slot — as the JAX engine does, on the same trace."""
    prompts = _prompts(model["jcfg"], 4, 8)
    results = []
    for side, err in ((True, JQueueFull), (False, QueueFull)):
        eng = _engine(model, side, 1, None, None, 0, dict(max_queue=1))
        eng.submit(prompts[0], 4)
        eng.step()                            # admit into the only slot
        eng.submit(prompts[1], 4)             # fills the queue
        with pytest.raises(err) as exc:
            eng.submit(prompts[2], 4)
        assert exc.value.retry_after >= 1.0
        assert eng.stats.rejected == 1
        while eng.scheduler.queue_depth:
            eng.step()
        expired = eng.submit(prompts[3], 4, queue_deadline_s=1e-9,
                             priority="best-effort")
        out = eng.run()
        assert expired.finish_reason.value == "expired"
        assert expired.tokens == [] and expired.slot == -1
        assert eng.stats.expired == 1
        results.append((out, eng.stats.rejected, eng.stats.expired,
                        eng.stats.finished))
    assert results[0] == results[1]
    assert len(results[1][0][1]) == 4
    with pytest.raises(ValueError, match="queue_deadline_s"):
        eng.submit(prompts[0], 4, queue_deadline_s=0)
    with pytest.raises(ValueError, match="unknown priority"):
        eng.submit(prompts[0], 4, priority="urgent")


def test_controller_priority_aware_holds_escalation():
    slo = SLOConfig(tpot_p95=0.01, max_queue=4, dwell=1,
                    priority_aware=True)
    ctl = AdaptiveController(num_rungs=3, slo=slo)
    over = [0.05] * 4
    assert ctl.update(over, queue_depth=0, best_effort_frac=0.0) == 0
    assert ctl.held_escalations == 1
    assert ctl.update(over, queue_depth=0, best_effort_frac=0.5) == 1
    assert ctl.update(over, queue_depth=10, best_effort_frac=0.0) == 2
    assert ctl.snapshot()["held_escalations"] == 1
    plain = AdaptiveController(
        num_rungs=3, slo=SLOConfig(tpot_p95=0.01, dwell=1))
    assert plain.update(over, queue_depth=0) == 1


def test_priority_aware_engine_holds_the_jax_engines_escalations(model):
    """A ladder engine under an SLO no step can meet (TPOT target 1 ns)
    with ``priority_aware``: while only interactive requests decode the
    controller holds its rung, and once a best-effort request decodes it
    escalates.  Tokens, rungs per token, transitions and held
    escalations equal the JAX engine's."""
    jl = JLadder.uniform(model["jparams"], model["jcfg"], (0.0, 0.5, 0.7))
    prompts = _prompts(model["jcfg"], 3, 10, step=3)
    slo = dict(tpot_p95=1e-9, max_queue=8, dwell=1, priority_aware=True)
    kw = dict(max_slots=3, max_len=32, prefill_chunk=8)
    engines = [
        JEngine(model["jparams"], model["jcfg"],
                JEngineConfig(slo=JSLOConfig(**slo), **kw), ladder=jl),
        Engine(model["params"], model["cfg"],
               EngineConfig(slo=SLOConfig(**slo), **kw),
               device="cpu", ladder=_tladder(jl))]
    outs = []
    for eng in engines:
        eng.submit(prompts[0], 8, priority="interactive")
        eng.submit(prompts[1], 8, priority="interactive")
        for _ in range(10):
            eng.step()
        eng.submit(prompts[2], 8, priority="best-effort")
        outs.append(eng.run())
    jeng, eng = engines
    assert outs[0] == outs[1]
    assert eng.controller.held_escalations == \
        jeng.controller.held_escalations > 0
    assert eng.controller.transitions == jeng.controller.transitions
    assert any(t[3] == "tpot" for t in eng.controller.transitions)
    for rid, rs in eng.states.items():
        assert rs.token_rungs == jeng.states[rid].token_rungs
    assert eng.decode_retraces_after_warmup == 0


# ---------------------------------------------------------------------------
# the serve CLI's admission flags
# ---------------------------------------------------------------------------

def test_serve_cli_preemption_and_prefix_cache(capsys):
    out = serve.main(["--reduced", "--device", "cpu", "--sparsity", "0",
                      "--batch", "3", "--prompt-len", "20", "--gen", "3",
                      "--prefix-cache", "--prefix-cache-tokens", "64",
                      "--max-queue", "4", "--preemption"])
    text = capsys.readouterr().out
    assert "prefix cache:" in text and "generated 9 tokens" in text
    assert sorted(out) == [0, 1, 2]
    args = serve.build_parser().parse_args([])
    assert (args.prefix_cache, args.prefix_cache_tokens, args.max_queue,
            args.preemption) == (False, 0, 0, False)


@pytest.mark.parametrize("argv,match", [
    (["--max-queue", "-1"], "--max-queue"),
    (["--prefix-cache-tokens", "8"], "--prefix-cache"),
])
def test_serve_cli_admission_flag_validation(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--reduced", "--device", "cpu"] + argv)
