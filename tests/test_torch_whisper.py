"""The port's enc-dec family (reduced whisper_large_v3: 2 encoder and 2
decoder layers, 16 frames, d_model 64) against the JAX package:
sinusoidal positions, the plain GELU MLP, bidirectional and cross
attention, the encoder, ``train`` logits with and without frames,
``prefill`` logits with the self and cross caches, 8 greedy ``decode``
steps from the padded caches under ``off``, ``mask`` and ``pallas``
(JAX's Pallas kernels interpreted, the port's plain versions), the
dense cross-KV stash after a sparse prefill, the loss and every grad
leaf, and the refusals the port mirrors (the engine, the serve CLI,
the train launcher's tokens-only batch) or adds (chunk and verify).

Inputs are made from a seed with numpy; weights are JAX's init, carried
over by ``models/params.from_numpy``.  Tolerance 1e-5 in f32
(``tests/test_kernels.py``); gradients as ``tests/test_torch_train.py``
holds them."""
import importlib.util
import pathlib
import sys
from unittest import mock

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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api, attention, layers, mlp
from repro_torch.models import model as TM
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.graphs import BatchDecodeSteps
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCH = "whisper_large_v3"
TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
TAUS = {"off": None, "mask": 0.05, "pallas": -np.inf}
B, S, GEN = 2, 12, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (jnp.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


@pytest.fixture(scope="module")
def m():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jparams = japi.init_model(jcfg, 0)
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((B, jcfg.encoder_frames, jcfg.d_model)
                                 ).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                jsp=jdefault_sp(jparams, jcfg, keep_frac=0.5),
                params=P.from_numpy(_np(jparams)), frames=frames, toks=toks)


def _policies(backend):
    return (JPolicy.uniform(backend, k_max_frac=0.5, block=16,
                            interpret=True),
            SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16))


def _sps(m, backend):
    tau = TAUS[backend]
    jsp = None if tau is None else _with_tau(m["jsp"], tau)
    return jsp, None if jsp is None else P.from_numpy(_np(jsp))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [64, 1280])
def test_sinusoidal_positions_match_jax(dim):
    """torch's and XLA's f32 ``exp`` differ by an ulp on some
    frequencies (at most 1), and sin/cos of ``position * freq`` carry that
    ulp times the position: 1e-5 up to position 31 (every position the
    reduced model reaches), 2 ulps of 1 times the position (3.6e-4 at
    1499) over whisper's 1500."""
    pos = np.array([0, 1, 7, 31], np.int32)
    _close(layers.sinusoidal_at(torch.from_numpy(pos), dim),
           jlayers.sinusoidal_at(jnp.asarray(pos), dim))
    got = layers.sinusoidal_positions(1500, dim)
    assert got.dtype == torch.float32 and got.shape == (1500, dim)
    want = np.asarray(jlayers.sinusoidal_positions(1500, dim))
    err = np.abs(got.numpy() - want)
    assert np.all(err <= 2 * 2.0 ** -23 * np.arange(1500)[:, None] + 1e-6)


def test_plain_gelu_mlp_matches_jax(m):
    assert set(mlp.mlp_schema(m["cfg"])) == {"wi", "wo"} == \
        set(jmlp.mlp_schema(m["jcfg"]))
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(
        np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                m["jparams"]["groups"][0]["l0"]["mlp"])
    tp = P.tree_map(lambda a: a[0], m["params"]["groups"][0]["l0"]["mlp"])
    _close(mlp.mlp_apply(tp, torch.from_numpy(x), m["cfg"]),
           jmlp.mlp_apply(jp, jnp.asarray(x), m["jcfg"]))


@pytest.mark.parametrize("S_,T", [(12, 16), (16, 16), (5, 1500)])
def test_noncausal_flash_attention_matches_jax(S_, T):
    """Bidirectional (S = T) and cross (S != T) attention; at T = 1500 the
    reference's online softmax runs two kv chunks of 750, the port one
    pass: equal up to f32 rounding."""
    rng = np.random.default_rng(T)
    q = rng.standard_normal((2, S_, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, T, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, T, 4, 16)).astype(np.float32)
    _close(attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=False),
           jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False))


def test_cross_decode_attention_matches_jax():
    """One query against a static (B,KV,hd,F) cache, no new-token term."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    pos = np.full((2,), 16, np.int32)
    _close(attention.decode_attention(*map(torch.from_numpy, (q, kc, vc,
                                                               pos))),
           jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, pos))))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_schema_and_cache_schema_match_jax(m):
    """The encoder subtree and the cross leaves, key path for key path,
    and the cross caches over F frames; padding the self caches to a
    longer T leaves F alone."""
    want = dict(P.tree_flatten_with_path(_np(m["jparams"])))
    got = P.tree_flatten_with_path(api.init_model(m["cfg"], 0,
                                                  device="cpu"))
    assert [p for p, _ in got] == list(want)
    assert all(tuple(t.shape) == want[p].shape for p, t in got)
    assert any(p[0] == "encoder" for p, _ in got)
    assert any("cross" in p for p, _ in got)
    jsch = japi.cache_schema(m["jcfg"], 3, 40)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jsch, is_leaf=lambda s: hasattr(s, "init"))[0]
    tleaves = P.tree_flatten_with_path(api.cache_schema(m["cfg"], 3, 40))
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in jleaves] == [p for p, _ in tleaves]
    assert [s.shape for _, s in jleaves] == [s.shape for _, s in tleaves]
    caches = api.init_caches(m["cfg"], 2, 12, device="cpu")
    padded = api.pad_caches(m["cfg"], caches, 2, 30)
    shapes = {p: tuple(t.shape) for p, t in P.tree_flatten_with_path(padded)}
    assert shapes[(0, 0, "cross", "k")] == (2, 2, 2, 16, 16)
    assert shapes[(0, 0, "self", "k")] == (2, 2, 2, 16, 30)
    assert shapes[(0, 0, "self", "v")] == (2, 2, 2, 30, 16)


def test_encode_matches_jax(m):
    got = TM.encode(m["params"], torch.from_numpy(m["frames"]), m["cfg"])
    _close(got, JM.encode(m["jparams"], jnp.asarray(m["frames"]), m["jcfg"]))


@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
@pytest.mark.parametrize("with_frames", [True, False])
def test_train_logits_match_jax(m, backend, with_frames):
    """With frames the cross-attention attends the encoder output;
    without, the layer's own input (the reference's
    ``kv_override=enc_out if enc_out is not None else x``)."""
    jpol, tpol = _policies(backend)
    jsp, sp = _sps(m, backend)
    kw = {"frames": m["frames"]} if with_frames else {}
    want, _ = jax.jit(lambda p, t, s, **k: JM.forward(
        p, m["jcfg"], tokens=t, mode="train", sp=s, policy=jpol, **k))(
        m["jparams"], jnp.asarray(m["toks"]), jsp,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got, _ = TM.forward(m["params"], m["cfg"],
                            tokens=torch.from_numpy(m["toks"]).long(),
                            mode="train", sp=sp, policy=tpol,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got, want)


@pytest.mark.parametrize("backend", ["off", "mask", "pallas"])
def test_prefill_caches_and_decode_match_jax(m, backend):
    """Prefill of 2 x 12 tokens over 16 frames (logits, self and cross
    caches), the caches padded to 20 positions as the reference's
    ``_pad_caches``, then 8 greedy decode steps (logits at each step,
    the caches after the last) in both packages; the port's steps are
    those ``chip_smoke.generate`` drives, and it gives these tokens, with
    the eager loop and with ``BatchDecodeSteps`` (the step built once)."""
    jcfg, cfg = m["jcfg"], m["cfg"]
    jpol, tpol = _policies(backend)
    jsp, sp = _sps(m, backend)
    fr = m["frames"]
    jprefill = jax.jit(japi.make_prefill_step(jcfg, policy=jpol))
    jdecode = jax.jit(japi.make_decode_step(jcfg, policy=jpol))
    jl, jc = jprefill(m["jparams"], {"tokens": jnp.asarray(m["toks"]),
                                     "frames": jnp.asarray(fr)}, jsp)
    prefill = api.make_prefill_step(cfg)
    decode = api.make_decode_step(cfg, tpol)
    with torch.no_grad():
        tl, tc = prefill(m["params"], torch.from_numpy(m["toks"]).long(),
                         sp, tpol, frames=torch.from_numpy(fr))
    _close(tl, jl)
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = P.tree_leaves(tc)
    assert len(jleaves) == len(tleaves) == 4          # self and cross k, v
    for a, b in zip(jleaves, tleaves):
        _close(b, a)
    T = S + GEN
    jc = jserve._pad_caches(jcfg, jc, B, T)
    tc = api.pad_caches(cfg, tc, B, T)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    tokens = [nxt]
    for i in range(GEN - 1):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jdecode(m["jparams"], {"tokens": jnp.asarray(nxt),
                                        "caches": jc,
                                        "positions": jnp.asarray(pos)}, jsp)
        with torch.no_grad():
            tl, tc = decode(m["params"], {
                "tokens": torch.from_numpy(nxt).long(), "caches": tc,
                "positions": torch.from_numpy(pos).long()}, sp)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tokens.append(nxt)
    for a, b in zip(jax.tree_util.tree_leaves(jc), P.tree_leaves(tc)):
        _close(b, a)
    for steps in (None, BatchDecodeSteps(cfg, m["params"], [(tpol, sp)],
                                         B, T, "cpu")):
        got = chip_smoke.generate(m["params"], cfg,
                                  torch.from_numpy(m["toks"]).long(), GEN,
                                  policy=tpol, sp=sp,
                                  frames=torch.from_numpy(fr), steps=steps)
        assert np.array_equal(got.numpy(), np.stack(tokens, 1))


@pytest.mark.parametrize("backend", ["mask", "pallas"])
def test_sparse_prefill_stashes_the_dense_cross_cache(m, backend):
    """The cross K/V a sparse prefill stashes are the dense projections
    of the encoder output, bit for bit (the reference's stash passes no
    sp tree), while its own cross-attention ran the sparse wk/wv."""
    _, tpol = _policies(backend)
    _, sp = _sps(m, backend)
    toks = torch.from_numpy(m["toks"]).long()
    fr = torch.from_numpy(m["frames"])
    prefill = api.make_prefill_step(m["cfg"])
    with torch.no_grad():
        sl, sc = prefill(m["params"], toks, sp, tpol, frames=fr)
        dl, dc = prefill(m["params"], toks, frames=fr)
    for kv in ("k", "v"):
        assert torch.equal(sc[0][0]["cross"][kv], dc[0][0]["cross"][kv])
    assert not torch.equal(sl, dl)


@pytest.mark.parametrize("with_frames", [True, False])
def test_loss_and_every_grad_leaf_match_jax(m, with_frames):
    batch = {"tokens": m["toks"]}
    if with_frames:
        batch["frames"] = m["frames"]
    fn = jax.jit(jax.value_and_grad(japi.make_loss_fn(m["jcfg"])))
    if with_frames:
        jloss, jgrads = fn(m["jparams"], jax.tree_util.tree_map(jnp.asarray,
                                                               batch))
    else:
        # the reference's loss reads batch["frames"]: it trains enc-dec
        # models only with frames, so the frame-less forward's grads are
        # taken through its forward directly
        def loss(p, t):
            logits, _ = JM.forward(p, m["jcfg"], tokens=t, mode="train")
            return japi.token_loss(m["jcfg"], logits, t)
        jloss, jgrads = jax.jit(jax.value_and_grad(loss))(
            m["jparams"], jnp.asarray(m["toks"]))
    params = P.from_numpy(_np(m["jparams"]))
    leaves = P.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    if with_frames:
        loss = api.make_loss_fn(m["cfg"])(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
    else:
        logits, _ = TM.forward(params, m["cfg"],
                               tokens=torch.from_numpy(m["toks"]).long())
        loss = api.token_loss(m["cfg"], logits,
                              torch.from_numpy(m["toks"]))
    # without frames the encoder takes no part: JAX's grads there are 0
    grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    assert abs(loss.item() - float(jloss)) <= TOL
    want = dict(P.tree_flatten_with_path(_np(jgrads)))
    got = P.tree_flatten_with_path(P.tree_unflatten_like(params,
                                                         list(grads)))
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_FLOOR * max(float(np.abs(w).max()), 1e-30),
            err_msg=str(path))
    enc_grads = [g for p, g in got if p[0] == "encoder"]
    assert any(float(g.abs().max()) > 0 for g in enc_grads) == with_frames


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper_large_v3", "internvl2_26b"])
def test_engine_refuses_like_jax(arch):
    """The JAX engine's exception type and message, before any other
    check."""
    with pytest.raises(NotImplementedError) as jexc:
        JEngine(None, jreduced(jget_config(arch)), JEngineConfig())
    with pytest.raises(NotImplementedError) as texc:
        Engine(None, reduced(get_config(arch)), EngineConfig(),
               device="cpu")
    assert str(texc.value) == str(jexc.value)
    assert str(texc.value).startswith(
        "serving engine supports token-only models, not ")


def test_serve_cli_refuses_whisper_like_jax():
    argv = ["--arch", ARCH, "--sparsity", "0", "--prompt-len", "8",
            "--gen", "2", "--batch", "2"]
    with mock.patch.object(sys, "argv", ["serve", *argv]), \
            pytest.raises(NotImplementedError) as jexc:
        jserve.main()
    with pytest.raises(NotImplementedError) as texc:
        tserve.main([*argv, "--reduced", "--device", "cpu"])
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("arch,key", [("whisper_large_v3", "frames"),
                                      ("internvl2_26b", "patch_embeds")])
def test_train_launcher_fails_like_jax(arch, key):
    """The launchers train on tokens alone, and the loss of both
    packages reads the family's second input from the batch."""
    from repro.launch import train as jtrain
    with pytest.raises(KeyError) as jexc:
        jtrain.train(arch, True, steps=1, batch=2, seq=8, log=lambda *a: None)
    with pytest.raises(KeyError) as texc:
        ttrain.train(arch, True, steps=1, batch=2, seq=8, device="cpu",
                     log=lambda *a: None)
    assert jexc.value.args == texc.value.args == (key,)


@pytest.mark.parametrize("arch", ["whisper_large_v3", "internvl2_26b"])
@pytest.mark.parametrize("mode", ["chunk", "verify"])
def test_chunk_and_verify_refuse_multimodal_families(arch, mode):
    """No reference entry point reaches these modes on these families
    (its engine refuses them); the port's forward refuses them."""
    cfg = reduced(get_config(arch))
    params = api.init_model(cfg, 0, device="cpu")
    caches = api.init_caches(cfg, 2, 16, device="cpu")
    kw = dict(positions=torch.zeros(2 if mode == "verify" else 1,
                                    dtype=torch.long))
    if mode == "chunk":
        kw["slot"] = torch.tensor(0)
    with pytest.raises(NotImplementedError, match=cfg.family):
        TM.forward(params, cfg,
                   tokens=torch.zeros((2 if mode == "verify" else 1, 4),
                                      dtype=torch.long),
                   mode=mode, caches=caches, **kw)
