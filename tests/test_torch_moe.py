"""The port's Mixture-of-Experts layer against the JAX package: the
router, the capacity dispatch, the expert-batched projections and
kernels' plain versions, the sp trees, and the reduced granite models'
logits in every serving mode.

Configs are ``reduced()`` (f32, 4 experts, top-2, expert d_ff 64) of
granite_moe_1b_a400m and granite_moe_3b_a800m, and a variant with 20
experts, top-4, which pads them to 32 (``num_experts_padded``): its 12
pad experts carry ``-inf`` router logits, as granite_moe_3b_a800m's 8
do at full width.  Weights are initialised by JAX and carried across by
``models/params.from_numpy``; attention, router and expert weights are
scaled by ``chip_smoke.GEMMA_WEIGHT_SCALE`` on both sides, so the MoE
output is of the order of its input (at the init it is about 1e-3 of
it) and the routing is not near uniform.

Tolerance 1e-5 (f32, sums in another order); dispatch tables, kept ids
and masked activations are compared for exact equality.  Sparse
backends run with ``block=16``, ``k_max_frac=0.5`` and an sp tree at
``keep_frac=0.5`` with a finite tau, so ``mask`` thresholds for real.
The tau is 0.05, not the 0.02 of the llama and Gemma tests: at 0.02 one
score of the chunk test's layer-1 ``moe/wo`` input lies 7.6e-6 (relative)
from tau, inside the f32 difference of the two packages' activations,
and the Eq. 5 decision flips (the threshold near-tie of ROADMAP Queue 3,
reference behaviour 4).
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import unstacked as JU
from repro.core.sp_schema import default_sp_stacked as jdefault_sp
from repro.kernels import ops as jops
from repro.kernels import sparse_matmul as JK
from repro.models import api as japi
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.configs import get_config, reduced
from repro_torch.core import sparse_linear
from repro_torch.core import unstacked as TU
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_matmul as K
from repro_torch.models import api, moe
from repro_torch.models import model as TM
from repro_torch.models import params as P
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 1e-5
TAU = 0.05
SCALE = chip_smoke.GEMMA_WEIGHT_SCALE
ARCHS = ["granite_moe_1b_a400m", "granite_moe_3b_a800m"]
BACKENDS = ["off", "mask", "topk_shared", "topk_block", "pallas"]
# (B, S) of x in each mode: decode (B, 1), a chunk (1, C), verify (S, 3)
SHAPES = {"decode": (3, 1), "chunk": (1, 16), "verify": (4, 3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch):
    name, _, experts = arch.partition("-E")
    jcfg, cfg = jreduced(jget_config(name)), reduced(get_config(name))
    if experts:
        kw = dict(num_experts=int(experts), num_experts_per_tok=4)
        jcfg = dataclasses.replace(jcfg, **kw)
        cfg = dataclasses.replace(cfg, **kw)
    return jcfg, cfg


def _scaled(jparams):
    """Attention, router and expert weights times SCALE."""
    def f(path, a):
        keys = [getattr(p, "key", None) for p in path]
        return a * SCALE if ("attn" in keys or "moe" in keys) else a
    return jax.tree_util.tree_map_with_path(f, jparams)


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
        jcfg, cfg = _configs(arch)
        jparams = _scaled(japi.init_model(jcfg, 0))
        jsp = _with_tau(jdefault_sp(jparams, jcfg, keep_frac=0.5), TAU)
        _MODELS[arch] = dict(
            jcfg=jcfg, cfg=cfg, jparams=jparams, jsp=jsp,
            params=P.from_numpy(_np(jparams)), sp=P.from_numpy(_np(jsp)))
    return _MODELS[arch]


def _layer(m):
    """Layer 0's MoE params and sp leaves in both packages."""
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                m["jparams"]["groups"][0]["l0"]["moe"])
    jsp = jax.tree_util.tree_map(lambda a: a[0], m["jsp"][0]["l0"]["moe"])
    return jp, jsp, P.from_numpy(_np(jp)), P.from_numpy(_np(jsp))


def _policies(backend):
    kw = dict(k_max_frac=0.5, block=16)
    return (JPolicy.uniform(backend, interpret=True, **kw),
            SparsityPolicy.uniform(backend, **kw))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _x(shape, d, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


# ---------------------------------------------------------------------------
# configs, capacity, the dispatch table
# ---------------------------------------------------------------------------

def test_configs_are_field_equal():
    for arch in ARCHS + ["granite_moe_3b_a800m-E20", "deepseek_67b"]:
        jcfg, cfg = _configs(arch)
        assert jcfg.__dict__ == cfg.__dict__
        assert jcfg.num_experts_padded == cfg.num_experts_padded
    assert _configs("granite_moe_3b_a800m-E20")[1].num_experts_padded == 32
    assert get_config("granite_moe_3b_a800m").num_experts_padded == 48


@pytest.mark.parametrize("arch", ARCHS + ["granite_moe_3b_a800m-E20"])
def test_capacity_matches_jax(arch):
    jcfg, cfg = _configs(arch)
    for S in (1, 2, 3, 7, 16, 32, 33, 100):
        assert moe._capacity(S, cfg) == jmoe._capacity(S, jcfg)
    full = get_config("granite_moe_3b_a800m")
    # decode (S = 1), a 32-token chunk, a verify window of 3
    assert [moe._capacity(S, full) for S in (1, 32, 3)] == [1, 9, 1]
    assert [jmoe._capacity(S, jget_config("granite_moe_3b_a800m"))
            for S in (1, 32, 3)] == [1, 9, 1]
    assert moe.expert_rows(full, 8, 1) == 8
    assert moe.expert_rows(full, 1, 32) == 9


def _last_write_table(topk, S, C, E):
    """The reference's dispatch scatter written as a loop: assignments in
    stable expert order, each writing ``where(keep, tok, S)`` at
    ``(e, where(keep, pos, 0))``, the last write winning."""
    B, _, K = topk.shape
    out = np.full((B, E, C), S, np.int64)
    for b in range(B):
        a = topk[b].reshape(-1)
        order = np.argsort(a, kind="stable")
        seen = np.zeros(E, np.int64)
        for i in order:
            e, pos = a[i], seen[a[i]]
            seen[e] += 1
            keep = pos < C
            out[b, e, pos if keep else 0] = i // K if keep else S
    return out


def test_dispatch_pads_position_zero_of_an_overflowing_expert():
    """Experts [0, 0, 0, 0, 1] (one per token), C = 2: expert 0 keeps
    tokens 0 and 1, then its two dropped tokens write the pad row (5) at
    its position 0, so token 0 loses expert 0's output."""
    topk = torch.tensor([[[0], [0], [0], [0], [1]]])
    disp, pos, counts = moe.dispatch(topk, 5, 2, 2)
    assert disp.tolist() == [[[5, 1], [4, 5]]]
    assert pos.reshape(-1).tolist() == [0, 1, 2, 3, 0]
    assert counts.tolist() == [[4, 1]]


@pytest.mark.parametrize("arch", ARCHS + ["granite_moe_3b_a800m-E20"])
@pytest.mark.parametrize("mode", list(SHAPES))
def test_dispatch_table_equals_the_reference_scatter(arch, mode):
    """The router's choices on the layer's input and the dispatch table
    built from them: experts equal JAX's ``lax.top_k``, gates within
    1e-5, and the table equal to the reference's last-write scatter.
    The verify windows overflow an expert's capacity (checked), and
    there position 0 of each overflowing expert holds the pad row."""
    m = _model(arch)
    cfg = m["cfg"]
    jp, _, tp, _ = _layer(m)
    B, S = SHAPES[mode]
    x = _x((B, S), cfg.d_model, seed=1)
    gate, topk = moe.route(tp, torch.from_numpy(x), cfg)
    jlogits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"],
                         preferred_element_type=jnp.float32)
    E = cfg.num_experts_padded
    if E != cfg.num_experts:
        jlogits = jlogits.at[..., cfg.num_experts:].set(-jnp.inf)
    jgate, jtopk = jax.lax.top_k(jax.nn.softmax(jlogits, -1),
                                 cfg.num_experts_per_tok)
    jgate = jgate / jnp.maximum(jgate.sum(-1, keepdims=True), 1e-9)
    assert np.array_equal(topk.numpy(), np.asarray(jtopk))
    _close(gate, jgate)
    assert int(topk.max()) < cfg.num_experts       # never a pad expert
    C = moe._capacity(S, cfg)
    disp, pos, counts = moe.dispatch(topk, S, C, E)
    want = _last_write_table(topk.numpy(), S, C, E)
    assert np.array_equal(disp.numpy(), want)
    over = counts.numpy() > C
    # decode never overflows (S = 1: K distinct experts); these verify
    # windows always do, and so does the padded variant's chunk
    assert over.any() == (mode == "verify" or (mode == "chunk"
                                              and arch.endswith("-E20")))
    assert (disp.numpy()[:, :, 0][over] == S).all()
    assert counts.sum().item() == B * S * cfg.num_experts_per_tok


# ---------------------------------------------------------------------------
# the expert-batched kernels' plain versions and projection
# ---------------------------------------------------------------------------

def _expert_inputs(E, R, n, m, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, R, n)).astype(np.float32))
    x[1] = 0                                  # an expert no token chose
    w = torch.from_numpy((rng.standard_normal((E, n, m)) * 0.1).astype(
        np.float32))
    g = torch.from_numpy((np.abs(rng.standard_normal((E, n))) + 0.1).astype(
        np.float32))
    return x.to(dtype), w.to(dtype), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,R,n,m,blk", [(4, 9, 64, 48, 16),
                                         (48, 8, 1536, 512, 128),
                                         (6, 1, 96, 32, 32)])
def test_expert_plain_kernels_equal_a_loop_over_experts(E, R, n, m, blk,
                                                        dtype):
    """``ref_score_select_experts`` and ``ref_sparse_matmul_shared_experts``
    are bit-equal to today's plain versions run expert by expert, tau
    -inf and finite; the all-zero expert keeps blocks 0..kb-1."""
    x, w, g = _expert_inputs(E, R, n, m, seed=E + R, dtype=dtype)
    nb = n // blk
    kb = max(1, nb // 2)
    a, kf = torch.tensor(1.0), torch.tensor(0.375)
    for tau in (float("-inf"), 0.5):
        t = torch.tensor(tau)
        xm, idx, bs = ref.ref_score_select_experts(x, g, a, t, kf, blk, kb)
        y = ref.ref_sparse_matmul_shared_experts(xm, w, idx, blk)
        assert y.shape == (E, R, m) and idx.dtype == torch.int32
        for e in range(E):
            want = ref.ref_score_select(x[e], g[e], a, t, kf, blk, kb)
            for got, w_ in zip((xm[e], idx[e], bs[e]), want):
                assert torch.equal(got, w_)
            assert torch.equal(y[e], ref.ref_sparse_matmul_shared(
                xm[e], w[e], idx[e], blk))
        assert idx[1].tolist() == list(range(kb))
        # the wrappers take the plain versions for CPU tensors
        got = K.score_select_experts(x, g, a, t, kf, kb=kb, blk=blk)
        assert all(torch.equal(u, v) for u, v in zip(got, (xm, idx, bs)))
        assert torch.equal(K.sparse_matmul_shared_experts(xm, w, idx,
                                                          blk=blk), y)


def test_expert_wrappers_never_fall_back_and_validate_shapes():
    """A non-CPU tensor goes to the kernel path, which refuses what it
    cannot launch; shapes are checked before either path."""
    x = torch.empty(3, 2, 256, device="meta")
    g = torch.empty(3, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.score_select_experts(x, g, 0.0, 0.0, 1.0, kb=1)
    with pytest.raises(ValueError, match="unsupported device"):
        K.sparse_matmul_shared_experts(
            x, torch.empty(3, 256, 8, device="meta"),
            torch.zeros(3, 1, dtype=torch.int32, device="meta"))
    x = torch.zeros(3, 2, 256)
    with pytest.raises(ValueError, match="multiple of blk"):
        K.score_select_experts(torch.zeros(3, 2, 200), torch.ones(3, 200),
                               0.0, 0.0, 1.0, kb=1, blk=128)
    with pytest.raises(ValueError, match="kb 3 outside"):
        K.score_select_experts(x, torch.ones(3, 256), 0.0, 0.0, 1.0, kb=3,
                               blk=128)
    with pytest.raises(ValueError, match="is not"):
        K.sparse_matmul_shared_experts(x, torch.zeros(3, 128, 4),
                                       torch.zeros(3, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="block_idx must be"):
        K.sparse_matmul_shared_experts(x, torch.zeros(3, 256, 4),
                                       torch.zeros(2, 1, dtype=torch.int32))


def test_expert_wrappers_on_cpu_take_the_plain_versions(monkeypatch):
    """CPU tensors never touch the kernel library: the expert wrappers
    return the plain versions' results and count no launch, under their
    own names or any other."""
    from repro_torch.kernels import build

    def no_library():
        raise AssertionError("the CPU route must not load the kernels")
    monkeypatch.setattr(build, "library", no_library)
    K.reset_launch_counts()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 64, 8)).astype(np.float32))
    g = torch.from_numpy(rng.random((3, 64)).astype(np.float32) + 0.5)
    got = K.score_select_experts(x, g, 0.5, 0.2, 0.5, kb=2, blk=16)
    want = ref.ref_score_select_experts(x, g, 0.5, 0.2, 0.5, 16, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(K.sparse_matmul_shared_experts(x, w, got[1], blk=16),
                       ref.ref_sparse_matmul_shared_experts(x, w, got[1], 16))
    assert K.launch_counts == {"score_select": 0, "sparse_matmul_shared": 0,
                               "sparse_matmul_per_seq": 0,
                               "score_select_experts": 0,
                               "sparse_matmul_shared_experts": 0}


def _jax_selection(x, g, sp, blk, kb):
    """The reference's steps 1-2 of ``kernels/ops.wisparse_project`` (the
    Pallas ``score_mask`` in interpret mode, ``lax.top_k``, the rank
    mask) under ``jax.vmap`` over experts: (xm, idx)."""
    nb = x.shape[-1] // blk

    def one(xe, ge):
        xm, bs = JK.score_mask(xe, ge, sp["alpha"], sp["tau"], blk=blk,
                               interpret=True)
        _, idx = jax.lax.top_k(bs, kb)
        kb_l = jnp.round(sp["keep_frac"] * nb).astype(jnp.int32)
        keep = jnp.zeros((nb,), bool).at[idx].set(jnp.arange(kb) < kb_l)
        return xm * jnp.repeat(keep, blk)[None].astype(xm.dtype), idx
    return jax.vmap(one)(x, g)


@pytest.mark.parametrize("tau", [float("-inf"), 0.3])
@pytest.mark.parametrize("E,R,n,blk", [(5, 1, 64, 16), (4, 6, 512, 16),
                                       (3, 11, 128, 32), (4, 11, 1024, 32)])
def test_ref_score_select_experts_matches_jax_vmap(E, R, n, blk, tau):
    """The expert selection's plain version against the reference's
    ``ref_score_mask`` under ``jax.vmap`` over experts, then
    ``lax.top_k`` of the block sums and the rank mask as
    ``kernels/ops.wisparse_project`` applies them, at the expert rows of
    a decode step and of 32-token chunks (R = 1, 6, 11) and nb = 4 and
    32: expert 1 all zero (ids 0..kb-1), expert 2's blocks tied in pairs
    (ranked lower id first), keep_frac 0.375 under kb/nb = 0.5.  xm and
    idx exact, bs within 1e-5."""
    from repro.kernels import ref as jref
    nb = n // blk
    kb = round(nb * 0.5)
    x, _, g = _expert_inputs(E, R, n, 1, seed=E * R + n)
    x2 = x[2].view(R, nb, blk)
    x2[:, 1::2] = x2[:, 0::2]
    g2 = g[2].view(nb, blk)
    g2[1::2] = g2[0::2]
    alpha, kf = 0.7, 0.375
    xm, idx, bs = ref.ref_score_select_experts(
        x, g, torch.tensor(alpha), torch.tensor(tau), torch.tensor(kf), blk,
        kb)

    def one(xe, ge):
        xm, bs = jref.ref_score_mask(xe, ge, alpha, tau, blk)
        _, idx = jax.lax.top_k(bs, kb)
        kb_l = jnp.round(jnp.float32(kf) * nb).astype(jnp.int32)
        keep = jnp.zeros((nb,), bool).at[idx].set(jnp.arange(kb) < kb_l)
        return xm * jnp.repeat(keep, blk)[None].astype(xm.dtype), idx, bs

    jxm, jidx, jbs = jax.jit(jax.vmap(one))(jnp.asarray(x.numpy()),
                                           jnp.asarray(g.numpy()))
    assert np.array_equal(xm.numpy(), np.asarray(jxm))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[1].tolist() == list(range(kb))
    assert torch.equal(bs[2, 0::2], bs[2, 1::2])
    _close(bs, jbs)


@pytest.mark.parametrize("tau", [float("-inf"), 0.3])
@pytest.mark.parametrize("n,m", [(64, 48), (80, 32)])
def test_wisparse_project_experts_matches_jax_vmap(n, m, tau):
    """The expert-batched ``pallas`` projection against JAX's ``vmap`` of
    ``kernels.ops.wisparse_project`` (Pallas in interpret mode): xm and
    the kept ids equal, outputs within 1e-5.  n = 80 pads the channels
    to three blocks of 32."""
    E, R, blk = 5, 9, 32
    x, w, g = _expert_inputs(E, R, n, m, seed=n + m)
    sp = {"alpha": torch.tensor(0.7), "tau": torch.tensor(tau),
          "keep_frac": torch.tensor(0.5)}
    jsp = {k: jnp.asarray(v.numpy()) for k, v in sp.items()}
    want = jax.vmap(lambda xe, we, ge: jops.wisparse_project(
        xe, we, {**jsp, "g": ge}, block=blk, k_frac=0.5, interpret=True))(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(g.numpy()))
    got = ops.wisparse_project_experts(x, w, {**sp, "g": g}, block=blk,
                                       k_frac=0.5)
    _close(got, want)
    _, n_pad, nb = ops.channel_plan(n, blk)
    kb = round(nb * 0.5)
    xp = torch.nn.functional.pad(x, (0, n_pad - n))
    gp = torch.nn.functional.pad(g, (0, n_pad - n))
    xm, idx, _ = K.score_select_experts(xp, gp, sp["alpha"], sp["tau"],
                                        sp["keep_frac"], kb=kb, blk=blk)
    jxm, jidx = _jax_selection(jnp.asarray(xp.numpy()), jnp.asarray(
        gp.numpy()), jsp, blk, kb)
    assert np.array_equal(xm.numpy(), np.asarray(jxm))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("backend", BACKENDS)
def test_project_experts_matches_jax_vmap_of_dense(backend):
    """``core/sparse_linear.project_experts`` against the reference's
    ``vmap`` of per-expert ``dense()`` with ``token_weights=None``."""
    from repro.models.layers import dense as jdense
    E, R, n, m = 6, 7, 64, 40
    x, w, g = _expert_inputs(E, R, n, m, seed=3)
    sp = {"alpha": torch.tensor(1.0), "tau": torch.tensor(0.3),
          "keep_frac": torch.tensor(0.5)}
    jsp = {k: jnp.asarray(v.numpy()) for k, v in sp.items()}
    jpol, tpol = _policies(backend)
    want = jax.vmap(lambda xe, we, ge: jdense(
        xe, we, {**jsp, "g": ge}, policy=jpol, role="moe/wi_gate",
        token_weights=None))(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                             jnp.asarray(g.numpy()))
    got = sparse_linear.project_experts(x, w, {**sp, "g": g}, policy=tpol,
                                        role="moe/wi_gate")
    _close(got, want)
    dense = sparse_linear.project_experts(x, w, None, policy=tpol)
    _close(dense, jnp.einsum("erd,edf->erf", jnp.asarray(x.numpy()),
                             jnp.asarray(w.numpy())))


def test_launch_plan_counts_the_expert_axis():
    """At granite_moe_3b_a800m's expert shapes the 48 experts fill the
    card with 4 x 48 or 12 x 48 tiles: one split, no scratch.  Fewer
    tiles split, and the scratch and counters are per (expert, tile)."""
    for R in (8, 9):
        p = K.launch_plan(R, 1536, 512, 6, 128, False, 2, 48)
        assert (p.grid, p.splits, p.workspace, p.counters) == \
            ((4, 1, 48), 1, 0, 0)
        p = K.launch_plan(R, 512, 1536, 2, 128, False, 2, 48)
        assert (p.grid, p.splits) == ((12, 1, 48), 1)
    p = K.launch_plan(40, 256, 128, 2, 128, False, 2, 4)
    assert p.grid == (1, 2, 8) and p.splits == 2
    assert p.workspace == 2 * 4 * 40 * 128 and p.counters == 8
    assert K.launch_plan(8, 256, 128, 2, 128, False) == \
        K.launch_plan(8, 256, 128, 2, 128, False, 2, 1)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS + ["granite_moe_3b_a800m-E20"])
def test_moe_apply_matches_jax(arch, mode, backend):
    """The whole MoE FFN at the shapes of decode (B, 1), a chunk (1, 16)
    and verify (4, 3); the verify windows (and the padded variant's
    chunk) overflow an expert's capacity
    (``test_dispatch_table_equals_the_reference_scatter``)."""
    m = _model(arch)
    jp, jsp, tp, tsp = _layer(m)
    jpol, tpol = _policies(backend)
    x = _x(SHAPES[mode], m["cfg"].d_model, seed=1)
    want = jmoe.moe_apply(jp, jnp.asarray(x), m["jcfg"], jsp, policy=jpol)
    got = moe.moe_apply(tp, torch.from_numpy(x), m["cfg"], tsp, policy=tpol)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 0.1   # not vanishing
    _close(got, want)


def test_moe_apply_without_sp_runs_dense():
    m = _model("granite_moe_3b_a800m")
    jp, _, tp, _ = _layer(m)
    x = _x((2, 5), m["cfg"].d_model, seed=2)
    _close(moe.moe_apply(tp, torch.from_numpy(x), m["cfg"]),
           jmoe.moe_apply(jp, jnp.asarray(x), m["jcfg"]))


def test_calibration_capture_on_expert_projections_raises():
    """(Named for the refusal it replaced.)  A dense calibration capture
    records each expert leaf once, with its (E, B*C, d) dispatched input:
    the reference's (B, E, C, d) capture with the expert axis first,
    capacity-padding rows included; with an sp entry for the leaf
    neither package records it.  ``build_context`` then keys it by the
    weight's identity and keeps it (E, T, d)."""
    from repro.sparsity import CaptureSink as JCaptureSink
    from repro_torch.core import calibration
    from repro_torch.sparsity import CaptureSink
    m = _model("granite_moe_1b_a400m")
    jp, jsp, tp, tsp = _layer(m)
    x = _x((2, 5), m["cfg"].d_model, seed=3)
    jcap, tcap = JCaptureSink(), CaptureSink()
    jmoe.moe_apply(jp, jnp.asarray(x), m["jcfg"],
                   policy=JPolicy.dense(capture=jcap))
    moe.moe_apply(tp, torch.from_numpy(x), m["cfg"],
                  policy=SparsityPolicy.dense(capture=tcap))
    names = ("wi_gate", "wi_up", "wo")
    assert [wid for wid, _ in tcap] == [id(tp[n]) for n in names]
    assert [wid for wid, _ in jcap] == [id(jp[n]) for n in names]
    for (_, tx), (_, jx) in zip(tcap, jcap):
        jx = np.asarray(jx)
        want = np.moveaxis(jx, 1, 0).reshape(jx.shape[1], -1, jx.shape[-1])
        _close(tx, want)
    jcap, tcap = JCaptureSink(), CaptureSink()
    jmoe.moe_apply(jp, jnp.asarray(x), m["jcfg"], jsp,
                   policy=JPolicy.dense(capture=jcap))
    moe.moe_apply(tp, torch.from_numpy(x), m["cfg"], tsp,
                  policy=SparsityPolicy.dense(capture=tcap))
    assert len(tcap) == len(jcap) == 0
    ctx = calibration.build_context(m["params"], m["cfg"],
                                    {"tokens": np.zeros((1, 8), np.int64)})
    E = m["cfg"].num_experts_padded
    for path in names:
        x0 = ctx.acts[(0, f"moe/{path}")]
        assert x0.dim() == 3 and x0.shape[0] == E
        assert tuple(ctx.g[(0, f"moe/{path}")].shape) == (E, x0.shape[2])


# ---------------------------------------------------------------------------
# params and sp trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["granite_moe_3b_a800m-E20"])
def test_params_and_sp_trees_carry_the_expert_leaves(arch):
    """``from_numpy``/``to_numpy`` carry the (reps, E, n, m) leaves across
    unchanged; the port's schema has the JAX shapes; the stacked and the
    per-layer sp trees give each expert its own g (rtol 1e-6), with one
    alpha, tau and keep_frac per layer."""
    m = _model(arch)
    want = _np(m["jparams"])
    got = P.to_numpy(m["params"])
    fw = jax.tree_util.tree_leaves_with_path(want)
    fg = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in fw] == [p for p, _ in fg]
    for (_, a), (_, b) in zip(fw, fg):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    E, d = m["cfg"].num_experts_padded, m["cfg"].d_model
    f = m["cfg"].expert_d_ff
    reps = m["cfg"].num_layers
    lp = m["params"]["groups"][0]["l0"]["moe"]
    assert tuple(lp["wi_gate"].shape) == (reps, E, d, f)
    assert tuple(lp["wo"].shape) == (reps, E, f, d)
    assert tuple(lp["router"].shape) == (reps, d, E)
    schema = TM.model_schema(m["cfg"])
    assert P.tree_map(lambda s: tuple(s.shape), schema) == \
        P.tree_map(lambda t: tuple(t.shape), m["params"])
    jsp = jdefault_sp(m["jparams"], m["jcfg"], keep_frac=0.5)
    tsp = default_sp_stacked(m["params"], m["cfg"], keep_frac=0.5)
    fw = jax.tree_util.tree_leaves_with_path(_np(jsp))
    fg = jax.tree_util.tree_leaves_with_path(P.to_numpy(tsp))
    assert [p for p, _ in fw] == [p for p, _ in fg]
    for (_, a), (_, b) in zip(fw, fg):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    leaf = tsp[0]["l0"]["moe"]["wi_gate"]
    assert tuple(leaf["g"].shape) == (reps, E, d)
    assert tuple(leaf["alpha"].shape) == (reps,)
    assert "router" not in tsp[0]["l0"]["moe"]
    jl = JU.default_layer_sp(jax.tree_util.tree_map(
        lambda a: a[0], m["jparams"]["groups"][0]["l0"]))
    tl = TU.default_layer_sp(P.tree_map(
        lambda a: a[0], m["params"]["groups"][0]["l0"]))
    fw = jax.tree_util.tree_leaves_with_path(_np(jl))
    fg = jax.tree_util.tree_leaves_with_path(P.to_numpy(tl))
    assert [p for p, _ in fw] == [p for p, _ in fg]
    for (_, a), (_, b) in zip(fw, fg):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_init_model_is_deterministic_for_expert_leaves():
    cfg = _configs("granite_moe_3b_a800m-E20")[1]
    a = api.init_model(cfg, 0, device="cpu")
    b = api.init_model(cfg, 0, device="cpu")
    c = api.init_model(cfg, 1, device="cpu")
    la, lb, lc = (t["groups"][0]["l0"]["moe"] for t in (a, b, c))
    for k in ("router", "wi_gate", "wi_up", "wo"):
        assert torch.equal(la[k], lb[k]) and not torch.equal(la[k], lc[k])
        assert float(la[k].abs().max()) <= 2 * 0.02 + 1e-6
    # each expert of a leaf draws its own values
    assert not torch.equal(la["wi_gate"][0, 0], la["wi_gate"][0, 1])


# ---------------------------------------------------------------------------
# logits of the reduced granites, every serving mode
# ---------------------------------------------------------------------------

MODEL_BACKENDS = ["off", "mask", "pallas"]


def _pool(m, slots, T, seed):
    rng = np.random.default_rng(seed)
    shapes = japi.cache_schema(m["jcfg"], slots, T)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.5).astype(np.float32),
        shapes, is_leaf=lambda s: hasattr(s, "init"))


def _caches_close(jc, tc):
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(P.to_numpy(tc))):
        _close(b, a)


@pytest.mark.parametrize("backend", MODEL_BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch, backend):
    m = _model(arch)
    jpol, tpol = _policies(backend)
    toks = np.random.default_rng(6).integers(0, 256, (2, 20))
    jl, jc = JM.forward(m["jparams"], m["jcfg"], tokens=jnp.asarray(toks),
                        mode="prefill", sp=m["jsp"], policy=jpol)
    tl, tc = TM.forward(m["params"], m["cfg"], tokens=torch.from_numpy(toks),
                        mode="prefill", sp=m["sp"], policy=tpol)
    _close(tl, jl)
    _caches_close(jc, tc)


@pytest.mark.parametrize("backend", MODEL_BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_jax(arch, backend):
    """Two decode steps over a pool of 3 slots, one inactive."""
    m = _model(arch)
    jpol, tpol = _policies(backend)
    caches = _pool(m, 3, 16, seed=7)
    jcaches = jax.tree_util.tree_map(jnp.asarray, caches)
    tcaches = P.from_numpy(caches)
    toks = np.array([5, 77, 200], np.int32)
    pos = np.array([3, 9, 14], np.int32)
    active = np.array([1.0, 0.0, 1.0], np.float32)
    for _ in range(2):
        jl, jcaches = JM.forward(
            m["jparams"], m["jcfg"], tokens=jnp.asarray(toks), mode="decode",
            caches=jcaches, positions=jnp.asarray(pos), sp=m["jsp"],
            policy=jpol, token_weights=jnp.asarray(active))
        tl, tcaches = TM.forward(
            m["params"], m["cfg"], tokens=torch.from_numpy(toks),
            mode="decode", caches=tcaches, positions=torch.from_numpy(pos),
            sp=m["sp"], policy=tpol, token_weights=torch.from_numpy(active))
        _close(tl, jl)
        _caches_close(jcaches, tcaches)
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("backend", MODEL_BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_logits_match_jax(arch, backend):
    """A 16-token chunk whose last 5 tokens are pad (token 0, weight 0):
    the pad rows route and take capacity, as in the reference."""
    m = _model(arch)
    jpol, tpol = _policies(backend)
    caches = _pool(m, 2, 40, seed=8)
    toks = np.random.default_rng(9).integers(0, 256, (1, 16))
    toks[0, 11:] = 0
    weights = np.array([1] * 11 + [0] * 5, np.float32)
    off, slot = 5, 1
    jl, jc = JM.forward(m["jparams"], m["jcfg"], tokens=jnp.asarray(toks),
                        mode="chunk",
                        caches=jax.tree_util.tree_map(jnp.asarray, caches),
                        positions=jnp.full((1,), off, jnp.int32),
                        slot=jnp.int32(slot), sp=m["jsp"], policy=jpol,
                        token_weights=jnp.asarray(weights))
    tcaches = P.from_numpy(caches)
    tl, _ = TM.forward(m["params"], m["cfg"], tokens=torch.from_numpy(toks),
                       mode="chunk", caches=tcaches,
                       positions=torch.full((1,), off),
                       slot=torch.tensor(slot), sp=m["sp"], policy=tpol,
                       token_weights=torch.from_numpy(weights))
    _close(tl, jl)
    _caches_close(jc, tcaches)


@pytest.mark.parametrize("backend", MODEL_BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_logits_match_jax(arch, backend):
    """A verify window of 3 per slot at per-row offsets, one inactive row
    in the slack."""
    m = _model(arch)
    jpol, tpol = _policies(backend)
    g1 = 3
    caches = _pool(m, 3, 24, seed=3)
    toks = np.random.default_rng(4).integers(0, 256, (3, g1))
    pos = np.array([7, 24 - g1, 0], np.int64)
    wts = np.repeat(np.array([1.0, 0.0, 1.0], np.float32)[:, None], g1, 1)
    jl, jc = japi.make_verify_step(m["jcfg"])(
        m["jparams"], jnp.asarray(toks), jnp.asarray(pos, jnp.int32),
        jax.tree_util.tree_map(jnp.asarray, caches), m["jsp"],
        jnp.asarray(wts), policy=jpol)
    tc = P.from_numpy(caches)
    tl, _ = api.make_verify_step(m["cfg"])(
        m["params"], torch.from_numpy(toks), torch.from_numpy(pos), tc,
        m["sp"], torch.from_numpy(wts), policy=tpol)
    assert tl.shape == (3, g1, m["cfg"].vocab_size)
    _close(tl, jl)
    _caches_close(jc, tc)
