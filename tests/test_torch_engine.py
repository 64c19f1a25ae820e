"""The port's serving engine against the JAX engine: same JAX-initialised
reduced llama31_8b, same trace, exactly equal greedy tokens.

Trace: ``max_slots=2``, ``max_len=64``, ``prefill_chunk=16``, prompts of
20/9/33 tokens from a numpy seed, 6 new tokens each — ragged prompts, a
queued third request, chunked prefill with the §5.1 dense first half,
and batched slot decode with an inactive slot.  Sparse policies use
``block=16``, ``k_max_frac=0.5`` and an sp tree at ``keep_frac=0.5``
with ``tau=-inf`` (the dense-equivalent mask; the reference's
uncalibrated ``tau=+inf`` zeroes every ``pallas`` projection)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import sparse_matmul as K
from repro_torch.launch import serve
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig, SLOConfig, SlotKVPool
from repro_torch.sparsity import SparsityPolicy

TRACE = dict(max_slots=2, max_len=64, prefill_chunk=16)
PROMPT_LENS = (20, 9, 33)
GEN = 6


def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    jsp = _with_tau(jdefault_sp(jparams, jcfg, keep_frac=0.5), -jnp.inf)
    npy = jax.tree_util.tree_map(np.asarray, (jparams, jsp))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    return dict(jcfg=jcfg, jparams=jparams, jsp=jsp,
                cfg=reduced(get_config("llama31_8b")),
                params=P.from_numpy(npy[0]), sp=P.from_numpy(npy[1]),
                prompts=prompts)


def _run(engine, prompts):
    for p in prompts:
        engine.submit(p, GEN)
    return engine.run()


@pytest.mark.parametrize("backend,strategy", [
    ("off", "chunked"), ("topk_block", "chunked"), ("pallas", "chunked"),
    ("topk_block", "whole")])
def test_engine_tokens_equal_jax(model, backend, strategy):
    kw = dict(TRACE, prefill_strategy=strategy)
    dense = backend == "off"
    jout = _run(JEngine(model["jparams"], model["jcfg"], JEngineConfig(
        policy=JPolicy.uniform(backend, k_max_frac=0.5, block=16), **kw),
        None if dense else model["jsp"]), model["prompts"])
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        policy=SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16),
        **kw), None if dense else model["sp"], device="cpu")
    tout = _run(eng, model["prompts"])
    assert tout == jout
    st = eng.stats
    assert st.finished == 3 and all(len(t) == GEN for t in tout.values())
    if strategy == "chunked":
        # §5.1: chunks starting at or past ceil(P/2) run sparse
        sparse = sum(1 for p in PROMPT_LENS for off in range(0, p, 16)
                     if off >= np.ceil(p / 2))
        assert st.prefill_sparse_chunks == (0 if dense else sparse)


def test_pallas_route_counts_no_launches_on_cpu(model):
    """On the CPU the wrappers take the plain versions, so a pallas run
    counts no kernel launch (on the card it counts one per projection)."""
    K.reset_launch_counts()
    eng = Engine(model["params"], model["cfg"], EngineConfig(
        policy=SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16),
        **TRACE), model["sp"], device="cpu")
    _run(eng, model["prompts"][:1])
    assert K.launch_counts == {"score_select": 0, "sparse_matmul_shared": 0,
                               "sparse_matmul_per_seq": 0}


def test_engine_needs_a_card_unless_asked_for_cpu(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model["params"], model["cfg"], EngineConfig(**TRACE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "8",
                    "--gen", "2"])


@pytest.mark.parametrize("field,value", [
    ("slo", SLOConfig(tpot_p95=1.0, priority_aware=True)),
    ("slo", SLOConfig(tpot_p95=1.0, quality_aware=True)),
    ("spec", object()),
    ("prefix_cache", True),
    ("scheduler", object())])
def test_unported_engine_features_raise(field, value):
    with pytest.raises(NotImplementedError):
        EngineConfig(**{field: value})


def test_unported_engine_arguments_raise(model):
    with pytest.raises(NotImplementedError):
        Engine(model["params"], model["cfg"], EngineConfig(**TRACE),
               device="cpu", telemetry=object())


def test_kv_pool_slot_bookkeeping(model):
    pool = SlotKVPool(model["cfg"], 2, 8, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1) and pool.num_free == 0
    with pytest.raises(RuntimeError):
        pool.alloc()
    pool.commit(a, 8)
    with pytest.raises(ValueError):
        pool.commit(a, 1)
    pool.free(a)
    with pytest.raises(ValueError):
        pool.free(a)
    assert pool.lengths[a] == 0 and pool.num_occupied == 1


def test_serve_cli_on_cpu(capsys):
    out = serve.main(["--reduced", "--device", "cpu", "--mode", "pallas",
                      "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    text = capsys.readouterr().out
    assert "tau=-inf" in text and "generated 6 tokens" in text
    assert sorted(out) == [0, 1] and all(len(t) == 3 for t in out.values())
    assert not serve.build_parser().parse_args([]).reduced
