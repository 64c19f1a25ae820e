"""WiSparse calibration over the enc-dec and VLM families (reduced
whisper_large_v3 with 2 x 16 frames, reduced internvl2_26b with 2 x 8
patch embeddings, 2 x 32 tokens each) against the JAX package: the
calibration context (captures, g, sizes, block io and whisper's encoder
output; ``cross/wk`` and ``cross/wv`` capture the B*F encoder rows,
``cross/wq`` the decoder's, the encoder's projections none; InternVL's
captures include the prefix rows), Eq. 7 thresholds, Eq. 6 and Eq. 8
on a tie-free sp list, Alg. 1-4 and the policy from the plan, and a
JAX-calibrated whisper plan shipped as the npz policy artifact, loaded
by each package, giving the JAX greedy tokens under ``mask`` and
``pallas`` (prefill, padded caches, decode: the engine refuses these
families in both packages).  The shared checks, models' seed and
tolerances are ``tests/torch_calib_parity.py``'s.

Reduced whisper's attention, cross-attention and MLP weights (encoder
and decoder) are scaled by ``chip_smoke.GEMMA_WEIGHT_SCALE`` on both
sides: at the init its residual stream is the sinusoidal positions
(entries up to 1, against weights of 0.02), a sparse plan moves its KL
(Eq. 8) by about 3e-6, and f32 rounding alone moves that by 1%; scaled,
the KL is about 4e-3, as the other archs', and the shared fitness
tolerance (rtol 1e-4) means what it says."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_calib_parity as C
from torch_threads import one_thread_module  # noqa: F401 (autouse)
from repro.core import calibration as JC
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.core import calibration as TC
from repro_torch.sparsity import SparsityPolicy

ARCHS = ["whisper_large_v3", "internvl2_26b"]
GEN = 8


class _Model(C._Model):
    """``torch_calib_parity``'s model with the family's second input in
    both packages' calibration batches."""

    def __missing__(self, key):
        if key == "jctx":
            val = JC.build_context(self["jparams"], self["jcfg"], {
                "tokens": jnp.asarray(self["toks"]),
                **{k: jnp.asarray(v) for k, v in self["inputs"].items()}})
        elif key == "tctx":
            val = TC.build_context(self["params"], self["cfg"],
                                   {"tokens": self["toks"], **self["inputs"]})
        else:
            return super().__missing__(key)
        self[key] = val
        return val


_MODELS = {}


def _scaled(jparams):
    """Attention, cross-attention and MLP weights times
    GEMMA_WEIGHT_SCALE."""
    def f(path, a):
        keys = {getattr(p, "key", None) for p in path}
        return a * C.chip_smoke.GEMMA_WEIGHT_SCALE \
            if keys & {"attn", "cross", "mlp"} else a
    return jax.tree_util.tree_map_with_path(f, jparams)


def _model(arch):
    if arch not in _MODELS:
        m = _Model(C.model(arch))
        jcfg = m["jcfg"]
        if jcfg.family == "encdec":
            m["jparams"] = _scaled(m["jparams"])
            m["params"] = C.P.from_numpy(C._np(m["jparams"]))
        rng = np.random.default_rng(C.DATA_SEED + 1)
        B = m["toks"].shape[0]
        if jcfg.family == "encdec":
            m["inputs"] = {"frames": rng.standard_normal(
                (B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)}
        else:
            m["inputs"] = {"patch_embeds": rng.standard_normal(
                (B, jcfg.vision_prefix, jcfg.d_model)).astype(np.float32)}
        _MODELS[arch] = m
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_context_matches(arch):
    m = _model(arch)
    C.check_build_context(m)
    jctx, tctx = m["jctx"], m["tctx"]
    B, S = m["toks"].shape
    if arch == "whisper_large_v3":
        F = m["jcfg"].encoder_frames
        np.testing.assert_allclose(tctx.enc_out.numpy(),
                                   np.asarray(jctx.enc_out), rtol=C.TOL,
                                   atol=C.TOL)
        for d in range(tctx.num_blocks):
            assert tctx.acts[(d, "cross/wk")].shape[0] == B * F
            assert tctx.acts[(d, "cross/wv")].shape[0] == B * F
            assert tctx.acts[(d, "cross/wq")].shape[0] == B * S
        assert len(tctx.acts) == 10 * tctx.num_blocks
    else:
        assert tctx.enc_out is None
        assert all(a.shape[0] == B * (8 + S) for a in tctx.acts.values())
        assert len(tctx.acts) == 7 * tctx.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_tau_for_matches(arch):
    C.check_tau_for(_model(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_block_mse_and_fitness_match(arch):
    C.check_evaluators(_model(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_pipeline_matches(arch):
    C.check_pipeline(_model(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_from_plan_matches(arch):
    C.check_policy(_model(arch))


def _jax_tokens(m, policy, sp, toks, frames):
    """The reference's prefill, its ``_pad_caches`` and decode steps,
    jitted, greedy."""
    jcfg = m["jcfg"]
    B, S = toks.shape
    prefill = jax.jit(japi.make_prefill_step(jcfg, policy=policy))
    decode = jax.jit(japi.make_decode_step(jcfg, policy=policy))
    logits, caches = prefill(m["jparams"], {"tokens": jnp.asarray(toks),
                                            "frames": jnp.asarray(frames)},
                             sp)
    caches = jserve._pad_caches(jcfg, caches, B, S + GEN)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [np.asarray(nxt)]
    for i in range(GEN - 1):
        logits, caches = decode(m["jparams"], {
            "tokens": nxt, "caches": caches,
            "positions": jnp.full((B,), S + i, jnp.int32)}, sp)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(nxt))
    return np.stack(out, 1)


@pytest.mark.parametrize("backend", ["mask", "pallas"])
def test_jax_plan_artifact_gives_the_jax_tokens(backend, tmp_path):
    """The JAX plan saved as the npz artifact by the JAX package, loaded
    by each (its sp leaves, ``cross/*`` among them, bit for bit), served
    by prefill and decode on 2 x 12 new tokens over fresh frames."""
    m = _model("whisper_large_v3")
    path = str(tmp_path / "plan.npz")
    m["jplan"].to_policy(backend=backend, block=C.BLOCK).save(
        path, sp=m["jplan"].stacked_sp)
    jpol, jsp = JPolicy.load(path)
    tpol, tsp = SparsityPolicy.load(path, device="cpu")
    assert tpol.to_dict() == {**jpol.to_dict(), "interpret": None}
    flat_j, flat_t = C.flat(jsp), C.flat(tsp)
    assert flat_j.keys() == flat_t.keys()
    assert any("/cross/" in k for k in flat_t)
    assert all(np.array_equal(flat_j[k], flat_t[k]) for k in flat_t)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, m["jcfg"].vocab_size, (2, 12)).astype(np.int32)
    frames = rng.standard_normal((2, 16, 64)).astype(np.float32)
    want = _jax_tokens(m, JPolicy.from_dict({**jpol.to_dict(),
                                             "interpret": True}),
                       jsp, toks, frames)
    got = C.chip_smoke.generate(m["params"], m["cfg"],
                                torch.from_numpy(toks).long(), GEN,
                                policy=tpol, sp=tsp,
                                frames=torch.from_numpy(frames))
    assert np.array_equal(got.numpy(), want)
