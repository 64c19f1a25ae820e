"""The port's ``launch/serve.generate`` against the JAX package's on the
other reduced archs, with JAX-initialised weights, under the default
policy (``mask`` with no sp tree) and ``topk_shared`` at keep 0.5:
gemma2_2b (attention and MLP weights scaled by
``chip_smoke.GEMMA_WEIGHT_SCALE``, else it emits one token; 24 prompt
and 16 new tokens roll its 32-position windows), mamba2_130m (the SSM
state in the padded caches) and internvl2_26b (its language model on
text alone).  whisper_large_v3 without frames: its prefill stashes no
cross cache, so both packages' padding raises ``ValueError`` (with
frames, ``tests/test_torch_whisper.py`` holds the loop).  And what the
inactive step of a ``BatchDecodeSteps`` build writes on filled caches
(a rolling window's column, every SSM leaf): only what the build puts
back.  Tokens must be exactly equal (f32 reduced configs)."""
import importlib.util
import pathlib

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
from repro_torch.models import params as P
from repro_torch.serving.graphs import BatchDecodeSteps
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B = 4
# (prompt length, new tokens) per arch
LENS = {"gemma2_2b": (24, 16), "mamba2_130m": (16, 8),
        "internvl2_26b": (16, 8), "whisper_large_v3": (16, 8),
        "llama31_8b": (16, 8)}
_MODELS = {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scaled(jparams):
    def f(path, a):
        keys = [getattr(p, "key", None) for p in path]
        return a * chip_smoke.GEMMA_WEIGHT_SCALE \
            if ("attn" in keys or "mlp" in keys) else a
    return jax.tree_util.tree_map_with_path(f, jparams)


def _model(arch):
    if arch not in _MODELS:
        jcfg = jreduced(jget_config(arch))
        jparams = japi.init_model(jcfg, 0)
        if arch.startswith("gemma"):
            jparams = _scaled(jparams)
        jsp = jdefault_sp(jparams, jcfg, keep_frac=0.5)
        S, _ = LENS[arch]
        _MODELS[arch] = dict(
            jcfg=jcfg, cfg=reduced(get_config(arch)), jparams=jparams,
            params=P.from_numpy(_np(jparams)), jsp=jsp,
            sp=P.from_numpy(_np(jsp)),
            prompts=SyntheticLM(DataConfig(jcfg.vocab_size, S, B)).batch(0))
    return _MODELS[arch]


@pytest.mark.parametrize("backend", [None, "topk_shared"])
@pytest.mark.parametrize("arch", ["gemma2_2b", "mamba2_130m",
                                  "internvl2_26b"])
def test_generate_equals_jax(arch, backend):
    m = _model(arch)
    _, gen = LENS[arch]
    jkw, kw = {}, {}
    if backend is not None:
        jkw = dict(sp_stacked=m["jsp"], policy=JPolicy.uniform(
            backend, k_max_frac=0.5, block=16))
        kw = dict(sp_stacked=m["sp"], policy=SparsityPolicy.uniform(
            backend, k_max_frac=0.5, block=16))
    want = np.asarray(jserve.generate(m["jparams"], m["jcfg"],
                                      jnp.asarray(m["prompts"]), gen, **jkw))
    got = serve.generate(m["params"], m["cfg"], m["prompts"], gen, **kw)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) > gen      # not one token repeated


def test_encdec_without_frames_fails_like_jax():
    """The loop takes tokens alone; an enc-dec prefill without frames
    stashes no cross cache, and both packages' padding to the cache schema
    (which has one) raises ``ValueError``."""
    m = _model("whisper_large_v3")
    S, gen = LENS["whisper_large_v3"]
    with pytest.raises(ValueError):
        jserve.generate(m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]),
                        gen)
    with pytest.raises(ValueError):
        serve.generate(m["params"], m["cfg"], m["prompts"], gen)


@pytest.mark.parametrize("arch", ["llama31_8b", "gemma2_2b",
                                  "mamba2_130m"])
def test_inactive_step_writes_only_what_a_build_puts_back(arch):
    """A build's warm call runs every row at ``total_len - 1`` (tokens 0):
    on filled caches it writes only the views ``written()`` lists, which
    the build restores: the last column of a full-length self cache (no
    loop step writes it), that column modulo the window in a rolling
    one (a live position there), every SSM leaf (each decode step
    advances every row's state)."""
    m = _model(arch)
    S, gen = LENS[arch]
    total = S + gen
    steps = BatchDecodeSteps(m["cfg"], m["params"],
                             [(SparsityPolicy.uniform("topk_shared",
                                                      k_max_frac=0.5),
                               m["sp"])], B, total, "cpu")
    rng = torch.Generator().manual_seed(0)
    for leaf in P.tree_leaves(steps.caches):
        leaf.copy_(torch.randn(leaf.shape, generator=rng))
    before = [t.clone() for t in P.tree_leaves(steps.caches)]
    cols = steps.written(0)
    saved = [c.clone() for c in cols]
    with torch.no_grad():
        steps._eager(0, torch.zeros(B, dtype=torch.long),
                     torch.full((B,), total - 1, dtype=torch.long))
    assert any(not torch.equal(c, k) for c, k in zip(cols, saved))
    for c, kept in zip(cols, saved):
        c.copy_(kept)
    for a, b in zip(before, P.tree_leaves(steps.caches), strict=True):
        assert torch.equal(a, b)
