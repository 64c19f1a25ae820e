"""The port's static-batch loop (``launch/serve.generate``, the serve CLI's
``--legacy``, ``serving/graphs.BatchDecodeSteps``) against the JAX
package's ``launch/serve.generate`` on reduced llama31_8b with
JAX-initialised weights: the prompt prefilled dense (``prefill_sparse_frac``
0.5) or sparse (1.0), the caches padded, ``gen - 1`` greedy decode steps,
under the default policy (``mask``, thresholds at tau 0.02),
``topk_shared`` at keep 0.5 and ``pallas`` at tau -inf (JAX's Pallas
kernels interpreted, the port's plain versions).  Also the reference's
invariant in the port (the whole-prefill engine gives ``generate``'s
tokens for equal-length prompts; ``tests/test_serving.py``), the steps'
build and step counts, and the CLI.

Other archs are in ``tests/test_torch_legacy_archs.py``.  Prompts are
``SyntheticLM`` batches; tokens must be exactly equal (f32 reduced
configs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.graphs import BatchDecodeSteps
from repro_torch.sparsity import PolicyLadder, SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

B, S, GEN = 4, 16, 8
# the default policy's Eq. 7 thresholds (uncalibrated: the reference's
# tau = +inf would mask every channel)
MASK_TAU = 0.02


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


@pytest.fixture(scope="module")
def m():
    jcfg = jreduced(jget_config("llama31_8b"))
    jparams = japi.init_model(jcfg, 0)
    jsp = jdefault_sp(jparams, jcfg, keep_frac=0.5)
    prompts = SyntheticLM(DataConfig(jcfg.vocab_size, S, B)).batch(0)
    return dict(jcfg=jcfg, cfg=reduced(get_config("llama31_8b")),
                jparams=jparams, params=P.from_numpy(_np(jparams)),
                jsp=jsp, prompts=prompts)


def _case(m, backend):
    """(JAX policy, JAX sp, port policy, port sp) of one case: ``None`` is
    the default policy, ``mask`` (thresholds at MASK_TAU)."""
    if backend is None:
        jsp = _with_tau(m["jsp"], MASK_TAU)
        return None, jsp, None, P.from_numpy(_np(jsp))
    jsp = _with_tau(m["jsp"], -jnp.inf) if backend == "pallas" else m["jsp"]
    return (JPolicy.uniform(backend, k_max_frac=0.5, block=16,
                            interpret=True), jsp,
            SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16),
            P.from_numpy(_np(jsp)))


@pytest.mark.parametrize("frac", [0.5, 1.0])
@pytest.mark.parametrize("backend", [None, "topk_shared", "pallas"])
def test_generate_equals_jax(m, backend, frac):
    jpol, jsp, pol, sp = _case(m, backend)
    want = np.asarray(jserve.generate(
        m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]), GEN, jsp,
        prefill_sparse_frac=frac, policy=jpol))
    got = serve.generate(m["params"], m["cfg"], m["prompts"], GEN, sp,
                         prefill_sparse_frac=frac, policy=pol)
    assert got.device.type == "cpu" and tuple(got.shape) == (B, GEN)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > GEN      # not one token repeated


@pytest.mark.parametrize("backend,keep", [("off", 1.0),
                                          ("topk_shared", 0.5)])
def test_whole_prefill_engine_equals_generate(m, backend, keep):
    """Equal-length prompts through the port's whole-prefill engine give
    the port's ``generate`` tokens exactly (``tests/test_serving.py``'s
    invariant of the reference)."""
    params, cfg = m["params"], m["cfg"]
    sp = None if backend == "off" else P.from_numpy(_np(m["jsp"]))
    policy = SparsityPolicy.uniform(backend, k_max_frac=keep)
    legacy = serve.generate(params, cfg, m["prompts"], GEN, sp,
                            policy=policy)
    eng = Engine(params, cfg, EngineConfig(
        max_slots=B, max_len=32, prefill_chunk=8, policy=policy,
        prefill_strategy="whole", prefill_dense_frac=1.0), sp, device="cpu")
    for b in range(B):
        eng.submit(m["prompts"][b], GEN)
    out = eng.run()
    for b in range(B):
        assert out[b] == legacy[b].tolist(), f"request {b} diverged"


def test_steps_build_once_per_key_and_count_each_step(m):
    """One build per key however often it decodes, one step per decode
    step, and a key's tokens those of ``generate`` under its policy."""
    params, cfg = m["params"], m["cfg"]
    sp = P.from_numpy(_np(m["jsp"]))
    topk = SparsityPolicy.uniform("topk_shared", k_max_frac=0.5)
    keys = [(SparsityPolicy.dense(), None), (topk, sp)]
    prompts = torch.from_numpy(m["prompts"]).long()
    steps = BatchDecodeSteps(cfg, params, keys, B, S + GEN, "cpu")
    assert steps.builds == 0 and steps.steps == [0, 0]
    with torch.no_grad():
        logits, caches = api.make_prefill_step(cfg)(params, prompts)
    caches = api.pad_caches(cfg, caches, B, S + GEN)
    first = torch.argmax(logits, -1)
    outs = [steps.decode(i, caches, first, S, GEN) for i in (0, 1, 0)]
    assert steps.builds == 2 and steps.built(0) and steps.built(1)
    assert steps.steps == [2 * (GEN - 1), GEN - 1]
    assert torch.equal(outs[0], outs[2])
    for out, (pol, s) in zip(outs, keys):
        assert torch.equal(out, serve.generate(params, cfg, m["prompts"],
                                               GEN, s, policy=pol))
    # the CPU captures nothing and reserves no scratch
    assert steps.captured == [{}, {}] and steps.space.pool is None


def test_generate_needs_no_sp_for_the_default_policy(m):
    """``generate(params, cfg, prompts, gen)``: the reference's defaults
    (``mask`` without an sp tree runs dense) give JAX's tokens."""
    want = np.asarray(jserve.generate(m["jparams"], m["jcfg"],
                                      jnp.asarray(m["prompts"]), GEN))
    got = serve.generate(m["params"], m["cfg"], m["prompts"], GEN)
    assert np.array_equal(got.numpy(), want)
    dense = serve.generate(m["params"], m["cfg"], m["prompts"], GEN,
                           policy=SparsityPolicy.dense())
    assert torch.equal(got, dense)


@pytest.mark.parametrize("argv", [
    ["--sparsity", "0"], ["--mode", "pallas"], ["--mode", "mask"],
    ["--mode", "topk_shared", "--sparsity", "0.3"]])
def test_serve_cli_legacy_runs(argv, capsys):
    out = serve.main(["--legacy", "--reduced", "--device", "cpu",
                      "--prompt-len", "12", "--gen", "6", "--batch", "2",
                      *argv])
    assert tuple(out.shape) == (2, 6)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("generated 12 tokens in ")
    assert lines[-2].endswith(" tok/s on cpu)")
    assert lines[-1] == f"sample: {out[0].numpy()}"


def test_serve_cli_legacy_serves_a_ladder_dense(tmp_path):
    """As the reference's: ``--legacy`` with ``--ladder`` loads and checks
    the ladder, then runs the loop dense."""
    cfg = reduced(get_config("llama31_8b"))
    path = str(tmp_path / "ladder.npz")
    PolicyLadder.uniform(api.init_model(cfg, 0, device="cpu"), cfg,
                         [0.0, 0.5]).save(path)
    base = ["--legacy", "--reduced", "--device", "cpu", "--prompt-len", "12",
            "--gen", "6", "--batch", "2"]
    dense = serve.main(base + ["--sparsity", "0"])
    assert torch.equal(serve.main(base + ["--ladder", path]), dense)
    with pytest.raises(SystemExit, match="out of range"):
        serve.main(base + ["--ladder", path, "--rung", "2"])
