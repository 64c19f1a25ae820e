"""The port's jamba_v01_52b hybrid (reduced, f32) against the JAX package.

Reduced jamba keeps the full 8-layer period in one stacked group: mamba
mixers with attention at period index 4 (no RoPE: ``rope_theta`` 0), and
dense and MoE FFNs in turn (4 experts, top-2).  Its logits in prefill and
over 8 decode steps under four backends and its unstacked forward are
held at 1e-5 by the checks of ``tests/test_torch_ssm.py``
(``check_prefill_and_decode``, ``check_unstacked``), on weights
initialised by JAX.  The JAX steps are jitted (one trace each).
"""
import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as TM
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "ssm_checks", pathlib.Path(__file__).resolve().parent / "test_torch_ssm.py")
ssm_checks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ssm_checks)


def _jamba():
    return ssm_checks._model("jamba_v01_52b")


@pytest.mark.parametrize("backend", ["off", "mask", "topk_shared", "pallas"])
def test_jamba_logits_in_prefill_and_decode_match_jax(backend):
    ssm_checks.check_prefill_and_decode(_jamba(), backend)


def test_jamba_unstacked_forward_and_blocks_match_jax():
    ssm_checks.check_unstacked(_jamba())


def test_jamba_attention_skips_rope():
    """jamba sets rope_theta 0: its attention layer (period index 4)
    takes no rotary embedding, in the port as in the reference; the
    logits of a jamba whose theta is set to 10000 differ."""
    m = _jamba()
    assert m["cfg"].rope_theta == 0.0 and m["cfg"].layer_pattern[4][0] == \
        "attn"
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 12)))
    base, _ = TM.forward(m["params"], m["cfg"], tokens=toks, mode="train")
    jl, _ = JM.forward(m["jparams"], m["jcfg"], tokens=jnp.asarray(toks),
                       mode="train")
    ssm_checks._close(base, jl)
    roped, _ = TM.forward(m["params"], dataclasses.replace(
        m["cfg"], rope_theta=10000.0), tokens=toks, mode="train")
    assert float((base - roped).abs().max()) > 1e-4


