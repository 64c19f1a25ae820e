"""The port on the card: its CUDA kernels against their plain versions,
the engine's captured steps, and the gateway and telemetry around them.

Marked ``gpu``: each test skips without a CUDA card (decided inside the
test, never at import).  On a machine with one, without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: kernel and plain version both upcast to f32 exactly and
accumulate in f32, so they differ only in summation order (1e-4)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_matmul as K
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.serving import Engine, EngineConfig
from repro_torch.sparsity import SparsityPolicy

pytestmark = pytest.mark.gpu

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,n,m,blk", [(1, 256, 128, 128), (13, 384, 131, 128),
                                       (8, 4096, 1024, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(dev, B, n, m, blk, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, n, device=dev, generator=gen).to(dtype)
    w = (torch.randn(n, m, device=dev, generator=gen) * 0.1).to(dtype)
    g = torch.rand(n, device=dev, generator=gen) + 0.1
    alpha, tau = torch.tensor(0.7, device=dev), torch.tensor(-1.0, device=dev)
    rw = torch.rand(B, device=dev, generator=gen)
    xm, bs = K.score_mask(x, g, alpha, tau, blk=blk, row_weights=rw)
    xm_r, bs_r = ref.ref_score_mask(x, g, alpha, tau, blk, rw)
    assert torch.equal(xm, xm_r)
    torch.testing.assert_close(bs, bs_r, rtol=1e-4, atol=1e-4)
    idx = torch.arange(0, n // blk, 2, dtype=torch.int32, device=dev)
    y = K.sparse_matmul_shared(xm, w, idx, blk=blk)
    torch.testing.assert_close(y, ref.ref_sparse_matmul_shared(xm, w, idx, blk),
                               rtol=1e-4, atol=1e-4)
    nb = n // blk
    kb = max(nb // 2, 1)
    ids = torch.stack([(torch.arange(kb, device=dev) + b) % nb
                       for b in range(B)]).to(torch.int32)
    y = K.sparse_matmul_per_seq(xm, w, ids, blk=blk)
    torch.testing.assert_close(
        y, ref.ref_sparse_matmul_per_seq(xm, w, ids, blk), rtol=1e-4,
        atol=1e-4)


def test_gemma2_whole_prefill_engine_on_card_matches_cpu(dev):
    """Reduced gemma2_2b (window 32), its decode graph built at the first
    decode step while the requests' windows are live: the build's warm
    call writes the scratch slot of every rolling window and puts it
    back, so greedy tokens equal the CPU's.  A sparse whole-prompt pass
    launches each kernel once per projection, eagerly."""
    cfg = reduced(get_config("gemma2_2b"))
    params = chip_smoke.scale_gemma_weights(
        api.init_model(cfg, 0, device="cpu"))
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n) for n in (40, 70, 70)]
    outs = []
    for d in (dev, torch.device("cpu")):
        K.reset_launch_counts()
        eng = Engine(
            P.tree_map(lambda t, d=d: t.to(d), params), cfg,
            EngineConfig(max_slots=3, max_len=128, prefill_chunk=16,
                         policy=pol, prefill_dense_frac=0.0),
            P.tree_map(lambda t, d=d: t.to(d), sp), device=d)
        assert eng.prefill_strategy == "whole"
        for p in prompts:
            eng.submit(p, 24)
        outs.append(eng.run())
        if d.type == "cuda":
            per = 7 * cfg.num_layers
            passes = eng.stats.prefill_chunks + eng.stats.decode_steps + 1
            assert eng.stats.prefill_chunks == 2       # 40, then 70 x 2
            assert eng.launches(K.launch_counts)["score_select"] == \
                per * passes
    assert outs[0] == outs[1]


def test_engine_on_card_matches_cpu_and_counts_launches(dev):
    """Greedy tokens equal the CPU's.  The decode step and the sparse
    prefill phase's chunk step run as CUDA graphs: the wrappers count
    each kernel once while it is captured, the replays count nothing, so
    the launches that ran are the warm calls before the captures plus
    the captured ones times the replays."""
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device="cpu")
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    prompts = [np.random.default_rng(1).integers(0, 256, n) for n in (20, 9)]
    outs = []
    for d in (dev, torch.device("cpu")):
        K.reset_launch_counts()
        eng = Engine(
            P.tree_map(lambda t, d=d: t.to(d), params), cfg,
            EngineConfig(max_slots=2, max_len=64, prefill_chunk=16,
                         policy=pol), P.tree_map(lambda t, d=d: t.to(d), sp),
            device=d)
        for p in prompts:
            eng.submit(p, 4)
        outs.append(eng.run())
        g, ch = eng.decode_graphs, eng.chunk_graphs
        assert g.builds == 1 and g.steps == [eng.stats.decode_steps]
        sparse_chunk = ch.index(0, pol.for_phase("prefill_sparse"))
        assert ch.builds == 2
        assert ch.steps[sparse_chunk] == eng.stats.prefill_sparse_chunks > 0
        if d.type == "cuda":
            per = 7 * cfg.num_layers
            ran = eng.stats.decode_steps + eng.stats.prefill_sparse_chunks \
                + 2                          # + the two warm calls
            for steps, i in ((g, 0), (ch, sparse_chunk)):
                assert steps.captured[i] == {
                    "score_select": per, "sparse_matmul_shared": per,
                    "sparse_matmul_per_seq": 0, "score_select_experts": 0,
                    "sparse_matmul_shared_experts": 0}
            assert eng.launches(K.launch_counts) == {
                "score_select": per * ran, "sparse_matmul_shared": per * ran,
                "sparse_matmul_per_seq": 0, "score_select_experts": 0,
                "sparse_matmul_shared_experts": 0}
            # warm + capture of the decode and the sparse chunk graphs
            assert K.launch_counts["score_select"] == per * 4
    assert outs[0] == outs[1]


def test_calibration_on_card(dev):
    """Eq. 7 thresholds computed on the card equal the CPU's on the same
    activations (rtol 1e-6: pow may differ by an ulp), and a small
    calibration on the card meets its budget with finite thresholds."""
    import dataclasses

    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig, weighted_average
    from repro_torch.data import DataConfig, SyntheticLM

    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device="cpu")
    toks = SyntheticLM(DataConfig(cfg.vocab_size, 48, 2)).batch(0)
    ctx_c = calibration.build_context(params, cfg, {"tokens": toks})
    ctx_g = dataclasses.replace(
        ctx_c, acts={k: v.to(dev) for k, v in ctx_c.acts.items()},
        g={k: v.to(dev) for k, v in ctx_c.g.items()}, _tau_cache={})
    for key in list(ctx_c.acts)[::2]:
        for alpha in (0.0, 0.55, 1.0, 1.5):
            for keep in (0.9, 0.5, 0.2):
                np.testing.assert_allclose(ctx_g.tau_for(key, alpha, keep),
                                           ctx_c.tau_for(key, alpha, keep),
                                           rtol=1e-6)
    params_g = P.tree_map(lambda t: t.to(dev), params)
    ctx = calibration.build_context(params_g, cfg, {"tokens": toks})
    plan = pipeline.run_pipeline(
        params_g, cfg, None, 0.5, evo=EvoConfig(generations=1, offspring=2,
                                                 eps=0.1),
        delta=0.25, coord_passes=0, ctx=ctx)
    assert 0.4 <= weighted_average(ctx, plan.block_ratios) <= 0.5 + 1e-9
    assert all(np.isfinite(t) for k, t in plan.taus.items()
               if plan.layer_ratios[k] > 0)
    assert plan.stacked_sp[0]["l0"]["attn"]["wq"]["tau"].device == dev


# llama31_8b's projection shapes (n, m): attn/wk and wv, mlp/wi_gate and
# wi_up, mlp/wo
MAIN_SHAPES = [(4096, 1024), (4096, 14336), (14336, 4096)]


def _matmul_inputs(dev, B, n, m, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, n, device=dev, generator=gen).to(dtype)
    w = (torch.randn(n, m, device=dev, generator=gen) * 0.02).to(dtype)
    return x, w


def _per_row_ids(B, nb, kb, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(nb)[:kb] for _ in range(B)]).astype(
        np.int32)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B", [1, 8, 13, 32, 33])
@pytest.mark.parametrize("n,m", MAIN_SHAPES)
def test_matmuls_at_main_path_shapes(dev, B, n, m):
    """Both block-gather kernels against their plain versions, bf16, half
    of the blocks kept (shared: one random set; per-seq: a random set per
    row)."""
    x, w = _matmul_inputs(dev, B, n, m, torch.bfloat16)
    nb = n // 128
    ids = _per_row_ids(B, nb, nb // 2)
    idx = torch.from_numpy(ids[0]).to(dev)
    _close(K.sparse_matmul_shared(x, w, idx),
           ref.ref_sparse_matmul_shared(x, w, idx, 128))
    idx2 = torch.from_numpy(ids).to(dev)
    _close(K.sparse_matmul_per_seq(x, w, idx2),
           ref.ref_sparse_matmul_per_seq(x, w, idx2, 128))


@pytest.mark.parametrize("B,n,m,kb,per_seq", [
    (8, 4096, 4096, 13, False), (13, 4096, 4096, 21, False),
    (33, 1024, 2048, 5, False), (8, 4480, 4096, 9, True),
    (13, 4480, 1024, 17, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmuls_split_k_with_ragged_slices(dev, B, n, m, kb, per_seq,
                                            dtype):
    """Shapes where the plan splits K (S > 1) into slices of unequal size
    (the units are not a multiple of S)."""
    plan = K.launch_plan(B, n, m, kb, 128, per_seq,
                         torch.empty((), dtype=dtype).element_size())
    assert plan.splits > 1 and plan.units % plan.splits != 0, plan
    x, w = _matmul_inputs(dev, B, n, m, dtype, seed=1)
    ids = _per_row_ids(B, n // 128, kb, seed=1)
    if per_seq:
        idx = torch.from_numpy(ids).to(dev)
        _close(K.sparse_matmul_per_seq(x, w, idx),
               ref.ref_sparse_matmul_per_seq(x, w, idx, 128))
    else:
        idx = torch.from_numpy(ids[0]).to(dev)
        _close(K.sparse_matmul_shared(x, w, idx),
               ref.ref_sparse_matmul_shared(x, w, idx, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmuls_duplicate_and_out_of_range_ids(dev, dtype):
    """A repeated id adds once per occurrence; ids outside [0, nb) are
    clamped, as the plain versions (and the reference) do."""
    x, w = _matmul_inputs(dev, 8, 1024, 512, dtype, seed=2)
    idx = torch.tensor([3, 3, -5, 999, 0, 3], dtype=torch.int32, device=dev)
    _close(K.sparse_matmul_shared(x, w, idx),
           ref.ref_sparse_matmul_shared(x, w, idx, 128))
    rows = [[3, 3, 3, 1], [-1, 0, 7, 8], [2, 2, 5, 5], [7, 7, 7, 7],
            [0, 1, 2, 3], [100, -100, 4, 4], [6, 6, 6, 0], [5, 4, 3, 2]]
    idx2 = torch.tensor(rows, dtype=torch.int32, device=dev)
    _close(K.sparse_matmul_per_seq(x, w, idx2),
           ref.ref_sparse_matmul_per_seq(x, w, idx2, 128))


@pytest.mark.parametrize("B", [8, 32])
def test_matmuls_two_launches_bit_equal(dev, B):
    """The split-K partials are summed in a fixed order: two launches give
    the same bits (serving runs must repeat their greedy tokens)."""
    x, w = _matmul_inputs(dev, B, 14336, 4096, torch.bfloat16, seed=3)
    ids = _per_row_ids(B, 112, 56, seed=3)
    idx = torch.from_numpy(ids[0]).to(dev)
    assert torch.equal(K.sparse_matmul_shared(x, w, idx),
                       K.sparse_matmul_shared(x, w, idx))
    idx2 = torch.from_numpy(ids).to(dev)
    assert torch.equal(K.sparse_matmul_per_seq(x, w, idx2),
                       K.sparse_matmul_per_seq(x, w, idx2))


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("n,m", MAIN_SHAPES)
def test_per_seq_with_shared_ids_matches_shared(dev, B, n, m):
    """Every row given the same ids, the per-seq kernel reads what the
    shared kernel reads.  It sums the kept blocks in block-id order and
    the shared kernel in idx order (with other split-K slices), so the two
    agree to f32 rounding (1e-4), not bit for bit."""
    x, w = _matmul_inputs(dev, B, n, m, torch.bfloat16, seed=4)
    nb = n // 128
    idx = torch.from_numpy(_per_row_ids(1, nb, nb // 2, seed=4)[0]).to(dev)
    _close(K.sparse_matmul_per_seq(x, w, idx.expand(B, -1).contiguous()),
           K.sparse_matmul_shared(x, w, idx))


def _separated(dev, B, n, dtype, blk=128, seed=5):
    """x whose channel blocks are scaled by 1.1**(a random permutation of
    0..nb-1): block scores 10% apart against a few % of noise, so no
    two lie within any summation-order tolerance (tie-free for idx)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = n // blk
    perm = torch.randperm(nb, device=dev, generator=gen).float()
    scale = (1.1 ** perm).repeat_interleave(blk)
    x = torch.randn(B, n, device=dev, generator=gen) * scale / 1.1 ** nb
    g = torch.rand(n, device=dev, generator=gen) * 0.2 + 0.9
    return x.to(dtype), g


@pytest.mark.parametrize("B,n", [(1, 256), (8, 4096), (32, 14336),
                                 (448, 4096), (13, 384)])
@pytest.mark.parametrize("keep_frac", [0.5, 0.375])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_select_matches_plain_version(dev, B, n, keep_frac, dtype):
    """Bit-equal xm and idx at tie-free block scores, bs to 1e-4; two
    launches bit-equal.  tau sits at half the median block's scale, so
    it masks channels in most blocks and whole blocks at the small end
    (their scores sum to exactly 0 in both versions)."""
    x, g = _separated(dev, B, n, dtype)
    alpha = torch.tensor(0.7, device=dev)
    tau = torch.tensor(0.5 * 1.1 ** (-(n // 128) / 2), device=dev)
    kf = torch.tensor(keep_frac, device=dev)
    rw = torch.rand(B, device=dev) + 0.5
    kb = max(1, round(n // 128 * 0.5))
    got = K.score_select(x, g, alpha, tau, kf, kb=kb, row_weights=rw)
    want = ref.ref_score_select(x, g, alpha, tau, kf, 128, kb, rw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    again = K.score_select(x, g, alpha, tau, kf, kb=kb, row_weights=rw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _separated_experts(dev, E, R, n, dtype, blk=128, seed=6):
    """Per expert, :func:`_separated`'s tie-free x and g; expert 1 is all
    zero (an expert that no token chose)."""
    xs, gs = zip(*(_separated(dev, R, n, dtype, blk, seed + e)
                   for e in range(E)))
    x = torch.stack(xs)
    x[1] = 0
    return x.contiguous(), torch.stack(gs).contiguous()


# granite_moe_3b_a800m's expert projections (48 experts, 8 decode rows or
# 9 rows of a 32-token chunk), granite_moe_1b_a400m's (32 experts), and
# an awkward f32 shape
EXPERT_SHAPES = [(48, 8, 1536, 512), (48, 9, 512, 1536), (32, 8, 1024, 512),
                 (5, 13, 384, 131)]
# the expert selection alone, (E, R, n): granite_moe_1b_a400m, granite_moe_
# 3b_a800m and jamba_v01_52b at decode rows (1, 8, 32, 448 slots) and the
# rows of a 32- and a 448-token chunk, both forms of the launch
SELECT_SHAPES = [(32, 1, 512), (32, 8, 1024), (32, 11, 1024),
                 (32, 141, 512), (48, 1, 1536), (48, 9, 512), (48, 32, 1536),
                 (48, 113, 1536), (48, 448, 512), (16, 1, 4096),
                 (16, 1, 14336), (16, 6, 4096), (16, 8, 4096),
                 (16, 8, 14336), (16, 71, 14336), (16, 448, 4096)]


@pytest.mark.parametrize("E,R,n,m", EXPERT_SHAPES)
@pytest.mark.parametrize("tau", [float("-inf"), 0.05])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_kernels_match_plain_versions(dev, E, R, n, m, tau, dtype):
    """The expert-batched ``score_select`` (one cluster per expert) and
    ``sparse_matmul_shared`` (experts in the grid) against their plain
    versions: xm and idx bit-equal at tie-free block scores, the
    all-zero expert's ids 0..kb-1, bs and y to 1e-4, two launches
    bit-equal, one launch each."""
    x, g = _separated_experts(dev, E, R, n, dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    w = (torch.randn(E, n, m, device=dev, generator=gen) * 0.1).to(dtype)
    alpha, t = torch.tensor(0.7, device=dev), torch.tensor(tau, device=dev)
    kf = torch.tensor(0.375, device=dev)
    kb = max(1, round(n // 128 * 0.5))
    K.reset_launch_counts()
    got = K.score_select_experts(x, g, alpha, t, kf, kb=kb)
    y = K.sparse_matmul_shared_experts(got[0], w, got[1])
    assert K.launch_counts == {"score_select": 0, "sparse_matmul_shared": 0,
                               "sparse_matmul_per_seq": 0,
                               "score_select_experts": 1,
                               "sparse_matmul_shared_experts": 1}
    want = ref.ref_score_select_experts(x, g, alpha, t, kf, 128, kb)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[1][1].tolist() == list(range(kb))
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    _close(y, ref.ref_sparse_matmul_shared_experts(got[0], w, got[1], 128))
    again = K.score_select_experts(x, g, alpha, t, kf, kb=kb)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(y, K.sparse_matmul_shared_experts(got[0], w, got[1]))


@pytest.mark.parametrize("E,R,n", SELECT_SHAPES)
@pytest.mark.parametrize("alpha,tau", [(1.0, float("-inf")), (0.7, 0.05)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_selection_matches_plain_version(dev, E, R, n, alpha, tau,
                                                dtype):
    """``score_select_experts`` in the form its shape takes (per expert
    or one cluster per expert, ``kernels/geometry``): xm and idx
    bit-equal to the plain version at tie-free block scores, with expert
    1 all zero (ids 0..kb-1) and expert 2's blocks tied in pairs (equal
    sums, ranked lower id first as ``lax.top_k`` ranks them), keep_frac
    0.375 under kb/nb = 0.5; bs to 1e-4; two launches bit-equal; one
    launch.  At alpha 1 (the uncalibrated sp tree's, where the kernel
    skips powf) and at alpha 0.7 with a finite tau."""
    from repro_torch.kernels import geometry as G
    x, g = _separated_experts(dev, E, R, n, dtype)
    nb = n // 128
    xt = x[2].view(R, nb, 128)
    xt[:, 1::2] = xt[:, 0::2]
    gt = g[2].view(nb, 128)
    gt[1::2] = gt[0::2]
    alpha, t = torch.tensor(alpha, device=dev), torch.tensor(tau, device=dev)
    kf = torch.tensor(0.375, device=dev)
    kb = max(1, round(nb * 0.5))
    K.reset_launch_counts()
    got = K.score_select_experts(x, g, alpha, t, kf, kb=kb)
    assert K.launch_counts["score_select_experts"] == 1
    want = ref.ref_score_select_experts(x, g, alpha, t, kf, 128, kb)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[1][1].tolist() == list(range(kb))
    assert torch.equal(got[2][2, 0::2], got[2][2, 1::2])
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    again = K.score_select_experts(x, g, alpha, t, kf, kb=kb)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    form = G.score_select_geometry(E, R, n, 128, kb, x.element_size(),
                                   experts=True).form
    assert form.startswith("expert") == (
        G.expert_config(R, n, 128, x.element_size()) is not None)


def test_powf_at_alpha_one_returns_every_float_unchanged(dev):
    """``score_select_experts``' per-expert form skips powf at alpha = 1
    and takes max(g, 1e-12) as it is; the plain version computes
    ``torch.pow`` (powf on the card).  The two are bit-equal only if
    powf(v, 1) == v for every float the kernel can be given there: every
    one from 1e-12 up to +inf, all 1,408,451,381 of them, checked here."""
    one = torch.tensor(1.0, device=dev)
    lo = int(np.array(1e-12, dtype=np.float32).view(np.int32))
    hi = 0x7F800000                                  # +inf
    for start in range(lo, hi + 1, 1 << 27):
        bits = torch.arange(start, min(start + (1 << 27), hi + 1),
                            dtype=torch.int32, device=dev)
        got = torch.pow(bits.view(torch.float32), one).view(torch.int32)
        assert torch.equal(got, bits), start


@pytest.mark.parametrize("R,n,m", [(8, 4096, 14336), (641, 14336, 4096)])
def test_expert_pair_at_jamba_expert_shapes(dev, R, n, m):
    """jamba_v01_52b's expert projections (16 experts, bf16): ``moe/wi``
    at a decode step's 8 rows and ``moe/wo`` at the 641 rows of a
    4096-token whole prefill, the ``_experts`` pair against its plain
    versions at alpha 0.7 and a finite tau (:func:`test_expert_kernels_
    match_plain_versions`' checks, one launch each)."""
    test_expert_kernels_match_plain_versions(dev, 16, R, n, m, 0.05,
                                             torch.bfloat16)


def test_jamba_with_sixteen_experts_on_card_matches_cpu(dev):
    """Reduced jamba_v01_52b with its published 16 experts (f32, weights
    from one CPU init): a whole-prefill ``pallas`` engine's greedy tokens
    on the card equal the CPU's, and every sparse pass launches 58 of
    each 2-D kernel and 12 of each ``_experts`` kernel
    (``chip_smoke.pass_launches``), the decode graph's recorded once per
    replay."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("jamba_v01_52b")),
                              num_experts=16)
    params = api.init_model(cfg, 0, device="cpu")
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 33)]
    per = {**chip_smoke.pass_launches(cfg), "sparse_matmul_per_seq": 0}
    assert per["score_select"] == 58 and per["score_select_experts"] == 12
    outs = []
    for d in (dev, torch.device("cpu")):
        K.reset_launch_counts()
        eng = Engine(P.tree_map(lambda t, d=d: t.to(d), params), cfg,
                     EngineConfig(max_slots=4, max_len=64, prefill_chunk=16,
                                  policy=pol, prefill_dense_frac=0.0),
                     P.tree_map(lambda t, d=d: t.to(d), sp), device=d)
        assert eng.prefill_strategy == "whole"
        for p in prompts:
            eng.submit(p, 10)
        outs.append(eng.run())
        if d.type == "cuda":
            g = eng.decode_graphs
            assert g.captured[0] == per
            ran = g.steps[0] + 1 + len(prompts)   # replays, warm, prefills
            assert eng.launches(K.launch_counts) == {
                k: v * ran for k, v in per.items()}
    assert outs[0] == outs[1]
    assert len({t for ts in outs[0].values() for t in ts}) > 8


@pytest.mark.parametrize("E,R,n,m,kb", [(4, 40, 256, 128, 2),
                                        (3, 33, 1024, 256, 7)])
def test_expert_matmul_split_k(dev, E, R, n, m, kb):
    """Few experts and tiles split K: the partials are per (expert,
    tile), summed in a fixed order."""
    plan = K.launch_plan(R, n, m, kb, 128, False, 2, E)
    assert plan.splits > 1, plan
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(E, R, n, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(E, n, m, device=dev, generator=gen) * 0.1).to(
        torch.bfloat16)
    idx = torch.stack([torch.randperm(n // 128, device=dev,
                                      generator=gen)[:kb]
                       for _ in range(E)]).to(torch.int32)
    y = K.sparse_matmul_shared_experts(x, w, idx)
    _close(y, ref.ref_sparse_matmul_shared_experts(x, w, idx, 128))
    assert torch.equal(y, K.sparse_matmul_shared_experts(x, w, idx))


def test_wisparse_project_experts_on_card_matches_cpu(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    E, R, n, m = 6, 9, 320, 96
    x = torch.randn(E, R, n, device=dev, generator=gen)
    w = torch.randn(E, n, m, device=dev, generator=gen) * 0.1
    sp = {"g": torch.rand(E, n, device=dev, generator=gen) + 0.1,
          "alpha": torch.tensor(0.7, device=dev),
          "tau": torch.tensor(-1.0, device=dev),
          "keep_frac": torch.tensor(0.5, device=dev)}
    got = ops.wisparse_project_experts(x, w, sp, block=64, k_frac=0.5)
    want = ops.wisparse_project_experts(
        x.cpu(), w.cpu(), {k: v.cpu() for k, v in sp.items()}, block=64,
        k_frac=0.5)
    _close(got.cpu(), want)


@pytest.mark.parametrize("arch", ["mamba2_130m", "jamba_v01_52b"])
def test_reduced_ssm_on_card_matches_cpu(dev, arch):
    """Reduced mamba2_130m and reduced jamba (f32, uncalibrated
    ``pallas``) on the card against the CPU: prefill and decode logits
    within 1e-4 and a whole-prefill engine's tokens
    (``chip_smoke.reduced_ssm_check``)."""
    chip_smoke.reduced_ssm_check(dev, arch)


def test_ssm_decode_build_on_a_busy_engine_leaves_live_rows(dev):
    """Reduced mamba2_130m under ``pallas`` on the card: three prompts
    prefilled whole, then the decode graph built while they are live.
    Its warm call runs every slot inactive, which advances every slot's
    conv windows and SSM state; the build puts them back, so every SSM
    leaf is bit-equal after it and the run's tokens equal the CPU
    engine's.  The sparse decode graph captured one launch of each
    kernel per projection: 6 per layer."""
    from repro_torch.serving import graphs
    cfg = reduced(get_config("mamba2_130m"))
    params = api.init_model(cfg, 0, device="cpu")
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (23, 9, 30)]
    outs = []
    for d in (dev, torch.device("cpu")):
        eng = Engine(P.tree_map(lambda t: t.to(d), params), cfg,
                     EngineConfig(max_slots=4, max_len=64, prefill_chunk=16,
                                  policy=pol),
                     P.tree_map(lambda t: t.to(d), sp), device=d)
        for p in prompts:
            eng.submit(p, 12)
        eng._admit()
        while eng.scheduler.prefilling:
            eng._prefill_whole(eng.scheduler.prefill_group())
        leaves = graphs.ssm_leaves(eng.pool.caches)
        live = [t.clone() for t in leaves]
        eng.decode_graphs.build(0)
        assert all(torch.equal(a, b) for a, b in zip(leaves, live))
        if d.type == "cuda":
            assert eng.decode_graphs.captured[0]["score_select"] == \
                eng.decode_graphs.captured[0]["sparse_matmul_shared"] == \
                6 * cfg.num_layers
        outs.append(eng.run())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m-E20", "mamba2_130m"])
def test_cpu_calibrated_plan_serves_the_cpu_tokens_on_card(dev, arch):
    """A plan calibrated on the CPU in f32 (paper Alg. 1-4 with the
    ``--calib-quick`` stages) of reduced granite_moe_3b_a800m with 20
    experts (per-expert g, top-k-scaled budgets; weights scaled as in
    ``tests/test_torch_moe.py``) and of reduced mamba2_130m, served under
    ``pallas`` with its finite taus: greedy tokens on the card equal the
    CPU's."""
    import dataclasses
    from repro_torch.core import pipeline
    from repro_torch.core.allocation import EvoConfig
    name, _, experts = arch.partition("-E")
    cfg = reduced(get_config(name))
    params = api.init_model(cfg, 0, device="cpu")
    if experts:
        cfg = dataclasses.replace(cfg, num_experts=int(experts),
                                  num_experts_per_tok=4)
        params = chip_smoke.scale_gemma_weights(
            api.init_model(cfg, 0, device="cpu"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    plan = pipeline.run_pipeline(
        params, cfg, {"tokens": toks}, 0.5,
        evo=EvoConfig(generations=1, offspring=2, eps=0.1), delta=0.25,
        coord_passes=0)
    assert any(np.isfinite(t) for t in plan.taus.values())
    pol = plan.to_policy(backend="pallas", block=16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 33)]
    outs = []
    for d in (dev, torch.device("cpu")):
        eng = Engine(P.tree_map(lambda t, d=d: t.to(d), params), cfg,
                     EngineConfig(max_slots=4, max_len=64, prefill_chunk=16,
                                  policy=pol),
                     P.tree_map(lambda t, d=d: t.to(d), plan.stacked_sp),
                     device=d)
        for p in prompts:
            eng.submit(p, 12)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert len({t for ts in outs[0].values() for t in ts}) > 1


def test_granite_engine_on_card_matches_cpu_and_counts_launches(dev):
    """Reduced granite_moe_3b_a800m with 20 experts (12 pad experts),
    its attention and MoE weights scaled as in ``tests/test_torch_moe.py``:
    greedy tokens equal the CPU's, and every sparse pass launches
    ``score_select`` and ``sparse_matmul_shared`` 4 times per layer (the
    attention projections) and each ``_experts`` kernel 3 times (the
    expert-batched ones), once per replay of a captured step."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("granite_moe_3b_a800m")),
                              num_experts=20, num_experts_per_tok=4)
    params = chip_smoke.scale_gemma_weights(
        api.init_model(cfg, 0, device="cpu"))
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n) for n in (20, 9, 33)]
    outs = []
    for d in (dev, torch.device("cpu")):
        K.reset_launch_counts()
        eng = Engine(
            P.tree_map(lambda t, d=d: t.to(d), params), cfg,
            EngineConfig(max_slots=4, max_len=64, prefill_chunk=16,
                         policy=pol), P.tree_map(lambda t, d=d: t.to(d), sp),
            device=d)
        assert eng.prefill_strategy == "chunked"
        for p in prompts:
            eng.submit(p, 8)
        outs.append(eng.run())
        if d.type == "cuda":
            attn, experts = 4 * cfg.num_layers, 3 * cfg.num_layers
            per = {"score_select": attn, "sparse_matmul_shared": attn,
                   "sparse_matmul_per_seq": 0,
                   "score_select_experts": experts,
                   "sparse_matmul_shared_experts": experts}
            g, ch = eng.decode_graphs, eng.chunk_graphs
            sparse_chunk = ch.index(0, pol.for_phase("prefill_sparse"))
            assert g.captured[0] == per
            assert ch.captured[sparse_chunk] == per
            ran = eng.stats.decode_steps + eng.stats.prefill_sparse_chunks \
                + 2
            assert eng.launches(K.launch_counts) == {
                k: v * ran for k, v in per.items()}
            assert ch.steps[sparse_chunk] == eng.stats.prefill_sparse_chunks
    assert outs[0] == outs[1]
    assert len({t for ts in outs[0].values() for t in ts}) > 8


@pytest.mark.parametrize("B,n,blk,offset", [(3, 300, 100, 0),
                                             (8, 4096, 128, 1),
                                             (5, 1000, 125, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_select_element_path(dev, B, n, blk, offset, dtype):
    """The kernel's one-element loads: a channel block that is not a
    multiple of 16 bytes, or x (and so xm's layout) not 16-byte aligned
    (a contiguous view ``offset`` elements into its buffer)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    buf = torch.randn(B * n + offset, device=dev, generator=gen)
    x = buf[offset:].view(B, n)
    # blocks 10% apart, as in _separated: no near tie for idx to break
    perm = torch.randperm(n // blk, device=dev, generator=gen).float()
    x.mul_((1.1 ** perm).repeat_interleave(blk))
    buf = buf.to(dtype)
    x = buf[offset:].view(B, n)
    g = torch.rand(n, device=dev, generator=gen) + 0.5
    alpha = torch.tensor(0.7, device=dev)
    tau = torch.tensor(0.3, device=dev)
    kf = torch.tensor(0.5, device=dev)
    kb = max(1, n // blk - 1)
    got = K.score_select(x, g, alpha, tau, kf, kb=kb, blk=blk)
    want = ref.ref_score_select(x, g, alpha, tau, kf, blk, kb)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("nb,blk", [(112, 128), (32, 128), (112, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_select_takes_lax_top_k_order_under_ties(dev, nb, blk, dtype):
    """Block scores that tie exactly (blocks repeat one pattern of
    quarter-integers, scaled by 2, 1 or 0, g = 1): the kernel keeps the
    lower ids first, bit for bit as the plain version does."""
    rng = np.random.default_rng(6)
    pat = rng.integers(-8, 9, (8, blk)).astype(np.float32) / 4
    counts = [nb // 10, nb // 2, nb - nb // 10 - nb // 2]
    mult = rng.permutation(np.repeat(np.float32([2, 1, 0]), counts))
    x = torch.from_numpy((pat[:, None, :] * mult[None, :, None]).reshape(
        8, nb * blk)).to(dev, dtype)
    g = torch.ones(nb * blk, device=dev)
    one = torch.tensor(1.0, device=dev)
    for keep_frac in (0.5, 0.375):
        kf = torch.tensor(keep_frac, device=dev)
        got = K.score_select(x, g, one, torch.tensor(-1.0, device=dev), kf,
                             kb=nb // 2, blk=blk)
        want = ref.ref_score_select(x, g, one, -1.0, kf, blk, nb // 2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _projection_inputs(dev, B, n, m, dtype):
    x, g = _separated(dev, B, n, dtype, seed=7)
    w = (torch.randn(n, m, device=dev) * 0.05).to(dtype)
    sp = {"g": g, "alpha": torch.tensor(0.7, device=dev),
          "tau": torch.tensor(0.5 * 1.1 ** (-(n // 128) / 2), device=dev),
          "keep_frac": torch.tensor(0.375, device=dev)}
    return x, w, sp


def test_wisparse_project_on_card_matches_cpu(dev):
    x, w, sp = _projection_inputs(dev, 6, 1024, 384, torch.float32)
    rw = torch.rand(6, device=dev)
    y = ops.wisparse_project(x, w, sp, k_frac=0.5, token_weights=rw)
    cpu = {k: v.cpu() for k, v in sp.items()}
    y_c = ops.wisparse_project(x.cpu(), w.cpu(), cpu, k_frac=0.5,
                               token_weights=rw.cpu())
    torch.testing.assert_close(y.cpu(), y_c, rtol=1e-4, atol=1e-4)


def test_pallas_projection_is_three_launches(dev):
    """score_select, the matmul and the output cast, nothing else
    (torch.profiler over one warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, w, sp = _projection_inputs(dev, 8, 4096, 1024, torch.bfloat16)
    rw = torch.ones(8, device=dev)
    ops.wisparse_project(x, w, sp, k_frac=0.5, token_weights=rw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.wisparse_project(x, w, sp, k_frac=0.5, token_weights=rw)
        torch.cuda.synchronize()
    launched = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    assert launched == 3, [e.key for e in prof.key_averages()]


# ---------------------------------------------------------------------------
# the decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _bf16_engine(dev, policy, sp=True, **kw):
    """A reduced llama31_8b in bf16 on the card, its slots decoding:
    8 requests prefilled into 8 slots (24 new tokens each, so none has
    finished when the last prefill ends)."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("llama31_8b")),
                              dtype="bfloat16")
    params = api.init_model(cfg, 0, device=dev)
    tree = default_sp_stacked(params, cfg, keep_frac=0.5,
                              tau=float("-inf")) if sp else None
    eng = Engine(params, cfg, EngineConfig(
        max_slots=8, max_len=64, prefill_chunk=16, policy=policy, **kw),
        tree, device=dev)
    rng = np.random.default_rng(3)
    for n in (20, 9, 33, 17, 40, 12, 25, 30):
        eng.submit(rng.integers(0, cfg.vocab_size, n), 24)
    while eng.scheduler.prefilling or eng.scheduler.has_queued():
        eng.step()
    return eng


@pytest.mark.parametrize("backend", ["off", "pallas"])
def test_graph_replay_equals_the_eager_step(dev, backend):
    """The captured step against the plain step on the same inputs
    (bf16, 3e-2 as the reference's bf16 kernel tests): the same greedy
    tokens.  The eager step writes the new K/V first; the replay writes
    the same values at the same positions."""
    pol = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    eng = _bf16_engine(dev, pol, sp=backend != "off")
    g = eng.decode_graphs
    for _ in range(3):
        tokens, positions, active = eng.decode_inputs()
        assert active.sum() == 8
        want = g.eager(0, tokens, positions, active).float().clone()
        nxt, got = g(0, tokens, positions, active)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
        assert np.array_equal(nxt, torch.argmax(want, -1).cpu().numpy())
        eng.step()                          # advance one real decode step
    assert g.builds == 1


def test_forced_rung_switches_never_rebuild(dev):
    """Every rung's graph is captured at warmup; switching rungs at every
    decode step replays them and builds nothing.  Tokens equal the CPU
    engine's under the same switches."""
    from repro_torch.sparsity import PolicyLadder
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device="cpu")
    ladder = PolicyLadder.uniform(params, cfg, budgets=(0.0, 0.5, 0.7),
                                  backend="pallas", block=16)
    outs, steps = [], []
    for d in (dev, torch.device("cpu")):
        rungs = PolicyLadder(
            budgets=ladder.budgets, policies=ladder.policies,
            sps=tuple(P.tree_map(lambda t, d=d: t.to(d),
                                 _with_tau(sp, float("-inf")))
                      for sp in ladder.sps))
        eng = Engine(P.tree_map(lambda t, d=d: t.to(d), params), cfg,
                     EngineConfig(max_slots=2, max_len=64, prefill_chunk=16),
                     ladder=rungs, device=d)
        eng.warmup()
        assert eng.decode_retraces_after_warmup == 0
        assert eng.decode_graphs.builds == 3
        rng = np.random.default_rng(1)
        for n in (20, 9, 14):
            eng.submit(rng.integers(0, 256, n), 9)
        while eng.scheduler.has_work():
            if eng.step() == "decode":
                eng.set_rung((eng.rung + 1) % 3)
        assert eng.decode_retraces_after_warmup == 0
        assert all(n > 0 for n in eng.decode_graphs.steps)
        outs.append({r: (rs.tokens, rs.token_rungs)
                     for r, rs in eng.states.items()})
        steps.append(eng.decode_graphs.steps)
    assert outs[0] == outs[1] and steps[0] == steps[1]


def _with_tau(tree, value):
    if isinstance(tree, dict):
        return {k: (torch.full_like(v, value) if k == "tau" else
                    _with_tau(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_tau(v, value) for v in tree]
    return tree


def test_sparse_chunk_after_capture_keeps_the_captured_scratch(dev,
                                                               monkeypatch):
    """The engine reserves the split-K scratch before its first capture,
    so sparse prefill chunks after it reuse the tensors the graph
    writes, and the graph holds them."""
    monkeypatch.setattr(K, "_scratch", {})
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    eng = _bf16_engine(dev, pol)            # captured at the first decode
    ws, cnt = K.scratch_tensors(dev)
    assert ws is not None and eng.decode_graphs.scratch[0] == (ws, cnt)
    sparse = eng.stats.prefill_sparse_chunks
    rng = np.random.default_rng(5)
    eng.submit(rng.integers(0, 256, 48), 4)    # chunks after the capture
    eng.run()
    assert eng.stats.prefill_sparse_chunks > sparse
    assert K.scratch_tensors(dev)[0] is ws and K.scratch_tensors(dev)[1] is cnt


# ---------------------------------------------------------------------------
# the chunk and verify steps as CUDA graphs, speculative decoding
# ---------------------------------------------------------------------------

def _pool_bytes(eng, slot=None):
    rows = [e["self"][k] if slot is None else e["self"][k][:, slot]
            for grp in eng.pool.caches for e in grp for k in ("k", "v")]
    return torch.cat([r.reshape(-1) for r in rows]).clone()


@pytest.mark.parametrize("backend", ["off", "pallas"])
def test_chunk_graph_equals_the_eager_chunk(dev, backend):
    """The captured chunk step against the plain one on the same inputs,
    chunk by chunk along one prompt: bit-equal logits and the same pool
    bytes (the eager step writes the chunk's K/V, the replay the same
    values again)."""
    pol = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    eng = _bf16_engine(dev, pol, sp=backend != "off")
    ch = eng.chunk_graphs
    i = ch.index(0, pol.for_phase("prefill_sparse"))
    assert ch.built(i)
    slot = eng.pool.alloc() if eng.pool.num_free else 0
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, eng.cfg.vocab_size, 48)
    w = np.ones(16, np.float32)
    for c in range(3):
        toks = prompt[16 * c:16 * (c + 1)][None].astype(np.int64)
        want = ch.eager(i, toks, 16 * c, slot, w).clone()
        want_pool = _pool_bytes(eng)
        got = ch(i, toks, 16 * c, slot, w)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(_pool_bytes(eng), want_pool)


def test_verify_graph_equals_the_eager_verify(dev):
    """The captured verify against the plain one on the same inputs:
    bit-equal logits and greedy tokens, the same pool bytes."""
    from repro_torch.serving import SpecConfig
    from repro_torch.sparsity import PolicyLadder
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("llama31_8b")),
                              dtype="bfloat16")
    params = api.init_model(cfg, 0, device=dev)
    ladder = PolicyLadder.uniform(params, cfg, budgets=(0.0, 0.5),
                                  backend="pallas", block=16)
    ladder = PolicyLadder(budgets=ladder.budgets, policies=ladder.policies,
                          sps=tuple(_with_tau(sp, float("-inf"))
                                    for sp in ladder.sps))
    eng = Engine(params, cfg, EngineConfig(
        max_slots=4, max_len=64, prefill_chunk=16,
        spec=SpecConfig(gamma=3, drafter_rung=1)), ladder=ladder,
        device=dev)
    vs = eng.spec_decoder.verify_steps
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 4))).to(dev)
    pos = torch.tensor([0, 5, 20, eng.pool_len - 4], device=dev)
    wts = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)[:, None].expand(
        4, 4)
    want = vs.eager(toks, pos, wts).clone()
    want_pool = _pool_bytes(eng)
    ver, got = vs(3, toks, pos, wts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ver, torch.argmax(want, -1))
    assert torch.equal(_pool_bytes(eng), want_pool)
    assert vs.builds == 1 and vs.steps == [1]


def test_spec_engine_on_card_matches_cpu_and_builds_once(dev):
    """The reduced spec engine (f32) gives the CPU's tokens and spec
    counters on the card.  Every decode, chunk and verify graph is
    captured at warmup: gamma and rung switches build nothing after."""
    from repro_torch.serving import SpecConfig
    from repro_torch.sparsity import PolicyLadder
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device="cpu")
    base = PolicyLadder.uniform(params, cfg, budgets=(0.0, 0.5, 0.7),
                                backend="pallas", block=16)
    spec = SpecConfig(gamma=2, drafter_rung=1, adaptive=True, gamma_min=1,
                      gamma_max=3, adapt_drafter=True, dwell=2)
    outs = []
    for d in (dev, torch.device("cpu")):
        ladder = PolicyLadder(
            budgets=base.budgets, policies=base.policies,
            sps=tuple(P.tree_map(lambda t, d=d: t.to(d),
                                 _with_tau(sp, float("-inf")))
                      for sp in base.sps))
        eng = Engine(P.tree_map(lambda t, d=d: t.to(d), params), cfg,
                     EngineConfig(max_slots=2, max_len=64, prefill_chunk=16,
                                  spec=spec), ladder=ladder, device=d)
        built = (eng.decode_graphs.builds, eng.chunk_graphs.builds,
                 eng.spec_decoder.verify_steps.builds)
        assert built == (3, 5, 3)
        rng = np.random.default_rng(1)
        for n in (20, 9, 14):
            eng.submit(rng.integers(0, 256, n), 12)
        gammas = []
        while eng.scheduler.has_work():
            if eng.step() == "decode":
                gammas.append(eng.spec_decoder.gamma)
                eng.spec_decoder.set_gamma(1 + len(gammas) % 3)
        assert (eng.decode_retraces_after_warmup,
                eng.chunk_retraces_after_warmup,
                eng.verify_retraces_after_warmup) == (0, 0, 0)
        assert all(n > 0 for n in eng.spec_decoder.verify_steps.steps)
        st = eng.stats
        outs.append(({r: rs.tokens for r, rs in eng.states.items()},
                     st.spec_rounds, st.spec_accepted_tokens,
                     st.spec_committed_tokens, gammas))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# prefix cache and preemption: segment copies into the captured pool
# ---------------------------------------------------------------------------

def _bf16_model(dev):
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("llama31_8b")),
                              dtype="bfloat16")
    return cfg, api.init_model(cfg, 0, device=dev)


def _slot_prefix(eng, slot, n):
    """Slot ``slot``'s K/V over positions [0, n), every leaf, cloned."""
    return [e["self"][k][:, slot, ..., :n].clone() if k == "k"
            else e["self"][k][:, slot, :, :n].clone()
            for grp in eng.pool.caches for e in grp for k in ("k", "v")]


def _ptrs(eng):
    return [e["self"][k].data_ptr() for grp in eng.pool.caches
            for e in grp for k in ("k", "v")]


def _record_prefills(eng, want):
    """Wrap ``eng._start_decode`` to keep the slot bytes [0, P) of the
    requests in ``want`` (by prompt length) when their prefill ends."""
    got = {}
    start = eng._start_decode

    def wrapped(rs, first):
        P = rs.request.prompt_len
        if P in want:
            got[P] = _slot_prefix(eng, rs.slot, P)
        start(rs, first)
    eng._start_decode = wrapped
    return got


def test_prefix_hit_slot_bytes_equal_cold_prefill(dev):
    """bf16 on the card, cache and preemption armed: a hit plus its
    suffix prefill leaves the slot's bytes over [0, P) bit-equal to a
    cold prefill of the same prompt; the first decode replay after the
    hit reads the copied bytes (the tokens equal the cold engine's); the
    pool tensors keep their addresses; nothing is built after warmup."""
    from repro_torch.serving import SchedulerConfig
    cfg, params = _bf16_model(dev)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, 32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, s)])
               for s in (8, 5, 12, 20)]
    runs = []
    for cache in (False, True):
        eng = Engine(params, cfg, EngineConfig(
            max_slots=4, max_len=64, prefill_chunk=16, prefill_dense_frac=1.0,
            prefix_cache=cache,
            scheduler=SchedulerConfig(preemption=True) if cache else None),
            device=dev)
        ptrs = _ptrs(eng)
        got = _record_prefills(eng, {37, 44, 52})
        eng.submit(prompts[0], 2)           # the donor
        eng.run()
        for p in prompts[1:]:
            eng.submit(p, 6)
        out = eng.run()
        assert _ptrs(eng) == ptrs
        if cache:
            assert eng.stats.prefix_hits == 3
            assert list(eng.stats.prefix_hit_len) == [32, 32, 32]
            assert (eng.decode_retraces_after_warmup,
                    eng.chunk_retraces_after_warmup) == (0, 0)
        runs.append((out, got))
    assert runs[0][0] == runs[1][0]
    for P in (37, 44, 52):
        for a, b in zip(runs[0][1][P], runs[1][1][P]):
            assert torch.equal(a, b), f"prompt of {P}: slot bytes differ"


def test_suspend_resume_bit_exact_on_card(dev):
    """suspend() copies a slot's segment to host memory; resume() writes
    it into another slot in place: bit-equal over [0, phys), the pool
    tensors at their addresses."""
    from repro_torch.serving import SlotKVPool
    cfg, _ = _bf16_model(dev)
    pool = SlotKVPool(cfg, 3, 40, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for grp in pool.caches:
        for e in grp:
            for k in ("k", "v"):
                e["self"][k].copy_(torch.randn(e["self"][k].shape,
                                               device=dev, generator=gen))
    ptrs = [e["self"][k].data_ptr() for grp in pool.caches for e in grp
            for k in ("k", "v")]
    src, dst = pool.alloc(), pool.alloc()
    pool.lengths[src] = 27
    seg = pool.suspend(src, quantum=8)
    assert (seg.length, seg.phys) == (27, 32)
    assert all(t.device.type == "cpu" for grp in seg.caches for e in grp
               for t in e["self"].values())
    pool.free(src)
    pool.resume(seg, dst)
    torch.cuda.synchronize()
    assert pool.lengths[dst] == 27
    for grp in pool.caches:
        for e in grp:
            k, v = e["self"]["k"], e["self"]["v"]
            assert torch.equal(k[:, dst, ..., :32], k[:, src, ..., :32])
            assert torch.equal(v[:, dst, :, :32], v[:, src, :, :32])
    assert [e["self"][k].data_ptr() for grp in pool.caches for e in grp
            for k in ("k", "v")] == ptrs


def test_preempted_engine_on_card_matches_uncontended(dev):
    """bf16 on the card, dense decode, the same 2 slots in both runs: an
    interactive arrival preempts a best-effort request, which resumes in
    another slot and finishes with the tokens of the run without
    preemption; nothing is built after warmup."""
    from repro_torch.serving import SchedulerConfig
    cfg, params = _bf16_model(dev)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 33, 12)]
    outs = []
    for preempt in (False, True):
        eng = Engine(params, cfg, EngineConfig(
            max_slots=2, max_len=64, prefill_chunk=16,
            scheduler=SchedulerConfig(preemption=preempt)), device=dev)
        ptrs = _ptrs(eng)
        for p in prompts[:2]:
            eng.submit(p, 16, priority="best-effort")
        while not (len(eng.scheduler.decoding) == 2 and all(
                len(rs.tokens) >= 2
                for rs in eng.scheduler.decoding.values())):
            eng.step()
        eng.submit(prompts[2], 6, priority="interactive")
        outs.append(eng.run())
        assert _ptrs(eng) == ptrs
        if preempt:
            assert eng.stats.preemptions == eng.stats.resumes >= 1
            assert (eng.decode_retraces_after_warmup,
                    eng.chunk_retraces_after_warmup) == (0, 0)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the gateway and telemetry on the card
# ---------------------------------------------------------------------------

def _http(port, body=None, path="/v1/generate"):
    """One request on a raw socket -> (status, body bytes)."""
    import json
    import socket
    payload = b"" if body is None else json.dumps(body).encode()
    method = "GET" if body is None else "POST"
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n".encode()
                  + payload)
        raw = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            raw += chunk
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def _sse_tokens(body):
    import json
    out, buf = b"", body
    while buf:
        size, _, buf = buf.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        out += buf[:n]
        buf = buf[n + 2:]
    events = [e[len("data: "):] for e in out.decode().split("\n\n") if e]
    assert events[-1] == "[DONE]" and json.loads(events[-2])["done"]
    return [json.loads(e)["token"] for e in events[:-2]]


def _reduced_pallas(dev):
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device=dev)
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    return cfg, params, sp, pol


def test_gateway_on_card_serves_the_direct_runs_tokens(dev):
    """A gateway over a reduced ``pallas`` engine on the card answers
    JSON and SSE requests, one after another, with the tokens of the same
    requests run directly on another engine; every step ran on the
    gateway's engine thread (graphs replayed there, built before it
    listened), and nothing was built after warmup."""
    import json
    import threading
    from repro_torch import obs
    from repro_torch.serving import Gateway
    cfg, params, sp, pol = _reduced_pallas(dev)
    ecfg = EngineConfig(max_slots=2, max_len=64, prefill_chunk=16,
                        policy=pol)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (20, 9, 33)]
    direct = Engine(params, cfg, ecfg, sp, device=dev)
    want = []
    for p in prompts:
        rs = direct.submit(p, 8)
        direct.run()
        want.append(rs.tokens)
    eng = Engine(params, cfg, ecfg, sp, device=dev)
    gw = Gateway(eng, port=0)
    assert eng.decode_retraces_after_warmup == 0
    threads, real_step = set(), eng.step

    def step():
        threads.add(threading.current_thread().name)
        return real_step()
    eng.step = step
    port = gw.start()
    try:
        got = []
        for i, p in enumerate(prompts):
            stream = i % 2 == 1
            status, body = _http(port, {"prompt": p, "max_new_tokens": 8,
                                        "stream": stream})
            assert status == 200
            got.append(_sse_tokens(body) if stream
                       else json.loads(body)["tokens"])
        status, body = _http(port, path="/metrics")
        assert status == 200 and obs.validate_exposition(body.decode()) > 0
    finally:
        gw.stop()
    assert got == want
    assert threads == {"gateway-engine"}
    assert sum(eng.decode_graphs.steps) == eng.stats.decode_steps > 0
    assert (eng.decode_retraces_after_warmup,
            eng.chunk_retraces_after_warmup) == (0, 0)


def test_metrics_scrape_during_a_capture(dev):
    """Scrapes on another thread while the main thread captures every
    graph (``Engine.warmup``): each scrape is valid, and the captures
    hold (a sync or a device read from the scraping thread would break a
    capture: the engine then serves the tokens of an engine warmed
    alone)."""
    import threading
    from repro_torch import obs
    cfg, params, sp, pol = _reduced_pallas(dev)
    ecfg = EngineConfig(max_slots=2, max_len=64, prefill_chunk=16,
                        policy=pol)
    eng = Engine(params, cfg, ecfg, sp, device=dev)
    done, scrapes, errors = threading.Event(), [], []

    def scrape():
        try:
            while not done.is_set():
                scrapes.append(obs.validate_exposition(
                    eng.metrics_exposition()))
        except Exception as e:                      # noqa: BLE001
            errors.append(e)
    t = threading.Thread(target=scrape)
    t.start()
    try:
        eng.warmup()
        torch.cuda.synchronize()
    finally:
        done.set()
        t.join(timeout=60)
    assert not errors and scrapes and not t.is_alive()
    ref = Engine(params, cfg, ecfg, sp, device=dev)
    ref.warmup()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9)]
    outs = []
    for e in (eng, ref):
        for p in prompts:
            e.submit(p, 6)
        outs.append(e.run())
    assert outs[0] == outs[1]
    assert eng.decode_retraces_after_warmup == 0


def test_profiler_session_trace_holds_the_kernels(dev, tmp_path):
    """A ``ProfilerSession`` window over decode steps of a ``pallas``
    engine exports a Chrome trace that holds the ``score_select`` and
    ``sparse_matmul_shared`` launches its graph replays made, and the
    engine's dispatch ranges when dispatch annotations are armed."""
    import json
    from repro_torch import obs
    cfg, params, sp, pol = _reduced_pallas(dev)
    tel = obs.Telemetry.full(profile_dir=str(tmp_path / "prof"))
    eng = Engine(params, cfg, EngineConfig(
        max_slots=2, max_len=64, prefill_chunk=16, policy=pol), sp,
        device=dev, telemetry=tel)
    eng.warmup()
    for n in (20, 9):
        eng.submit(np.random.default_rng(n).integers(0, cfg.vocab_size, n),
                   12)
    while eng.scheduler.prefilling or eng.scheduler.has_queued():
        eng.step()
    assert tel.profiler.start()
    for _ in range(4):
        assert eng.step() == "decode"
    assert tel.profiler.stop() and tel.profiler.error is None
    with open(tel.profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for k in ("score_select", "sparse_matmul_shared"):
        assert any(k in n for n in kernels), (k, kernels[:20])
    assert "repro/decode" in {e.get("name") for e in events}
    eng.run()
    eng.close()


def test_a_dead_engine_in_a_cycle_never_breaks_a_capture(dev):
    """Destroying a CUDA graph while another is captured invalidates the
    capture, and an engine dropped inside a reference cycle keeps its
    graphs until the collector runs.  With the collector made to run at
    nearly every allocation, a second engine still captures every step
    (each capture collects first and runs with the collector off), and
    serves the tokens of an engine built alone."""
    import gc
    cfg, params, sp, pol = _reduced_pallas(dev)
    ecfg = EngineConfig(max_slots=2, max_len=64, prefill_chunk=16,
                        policy=pol)
    old = gc.get_threshold()
    dead = Engine(params, cfg, ecfg, sp, device=dev)
    dead.warmup()
    dead.cycle = dead
    del dead
    try:
        gc.set_threshold(1)
        eng = Engine(params, cfg, ecfg, sp, device=dev)
        eng.warmup()
    finally:
        gc.set_threshold(*old)
    ref = Engine(params, cfg, ecfg, sp, device=dev)
    prompts = [np.random.default_rng(n).integers(0, cfg.vocab_size, n)
               for n in (20, 9)]
    outs = []
    for e in (eng, ref):
        for p in prompts:
            e.submit(p, 6)
        outs.append(e.run())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the quality monitor and the flight recorder on the card
# ---------------------------------------------------------------------------

def _bf16_ladder_engine(dev, telemetry=None, **kw):
    """A reduced llama31_8b in bf16 on the card serving a ``pallas``
    ladder (0.0/0.5/0.7, block 16, tau=-inf) from rung 1."""
    import dataclasses
    from repro_torch.sparsity import PolicyLadder
    cfg = dataclasses.replace(reduced(get_config("llama31_8b")),
                              dtype="bfloat16")
    params = kw.pop("params", None) or api.init_model(cfg, 0, device=dev)
    lad = PolicyLadder.uniform(params, cfg, budgets=(0.0, 0.5, 0.7),
                               backend="pallas", block=16)
    lad = PolicyLadder(budgets=lad.budgets, policies=lad.policies,
                       sps=tuple(_with_tau(sp, float("-inf"))
                                 for sp in lad.sps))
    ecfg = EngineConfig(max_slots=4, max_len=64, prefill_chunk=16,
                        initial_rung=kw.pop("rung", 1), **kw)
    return Engine(params, cfg, ecfg, ladder=lad, device=dev,
                  telemetry=telemetry), params


def _serve_prompts(eng, n=6, gen=12, seed=4):
    rng = np.random.default_rng(seed)
    for L in (20, 9, 33, 17, 40, 12)[:n]:
        eng.submit(rng.integers(0, eng.cfg.vocab_size, L), gen)
    eng.run()
    return {r: (rs.tokens, rs.token_rungs) for r, rs in eng.states.items()}


def test_quality_probe_and_recon_graphs_built_once(dev):
    """The probe (a window-1 dense verify) and the recon pass are each
    captured once at warmup and replayed per probe and per recon pass;
    nothing is built after warmup, and neither launches a sparse kernel:
    the engine's launches equal its sparse passes."""
    from repro_torch import obs
    K.reset_launch_counts()
    q = obs.QualityMonitor(probe_rate=1.0, recon_every=1, recon_window=8)
    eng, _ = _bf16_ladder_engine(dev, obs.Telemetry(quality=q))
    _serve_prompts(eng)
    assert q.probe_steps.builds == 1 and q.recon_steps.builds == 1
    assert eng.probe_retraces_after_warmup == 0
    assert eng.decode_retraces_after_warmup == 0
    assert q.probe_steps.steps == [q.probes] and q.probes == \
        eng.stats.decode_steps
    assert q.recon_steps.steps == [q.recon_passes] and q.recon_passes > 0
    zero = {"score_select": 0, "sparse_matmul_shared": 0,
            "sparse_matmul_per_seq": 0, "score_select_experts": 0,
            "sparse_matmul_shared_experts": 0}
    assert q.probe_steps.captured == [zero]
    assert q.recon_steps.captured == [zero]
    # each sparse graph: its eager warm call, then one run per replay
    per = 7 * eng.cfg.num_layers
    dec, ch = eng.decode_graphs, eng.chunk_graphs
    passes = sum(dec.steps[r] + 1 for r in (1, 2)) + sum(
        ch.steps[i] + 1 for i, k in enumerate(ch.keys)
        if not k[1].is_dense)
    ran = eng.launches(K.launch_counts)
    assert ran["score_select"] == ran["sparse_matmul_shared"] \
        == per * passes
    u = q.decode_utilization(eng.stats.decode_step_hist.mean)
    assert set(u) == {0, 1, 2} and all(0 < v <= 1.05 for v in u.values())


def test_recon_graph_equals_the_eager_pass_on_every_rung(dev):
    """One recon graph serves every rung through its staging sp tree:
    each rung's replay equals the eager pass under that rung's sp."""
    from repro_torch import obs
    q = obs.QualityMonitor(probe_rate=1.0, recon_every=1, recon_window=8)
    eng, _ = _bf16_ladder_engine(dev, obs.Telemetry(quality=q))
    tokens = np.arange(1, 9, dtype=np.int64).reshape(1, 8)
    for r in (2, 0, 1):
        want = q.recon_steps._eager(torch.from_numpy(tokens).to(dev),
                                    eng._rung_sp[r])
        want = tuple(t.clone() for t in want)
        got = q.recon_steps(tokens, eng._rung_sp[r])
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    assert q.recon_steps.builds == 1


def test_probes_leave_bf16_tokens_unchanged(dev):
    """Probing every decode step (with recon passes) serves the tokens
    and rung residency of a probe-free run, bit for bit, in bf16."""
    from repro_torch import obs
    q = obs.QualityMonitor(probe_rate=1.0, recon_every=2, recon_window=8)
    probed, params = _bf16_ladder_engine(dev, obs.Telemetry(quality=q))
    bare, _ = _bf16_ladder_engine(dev, params=params)
    assert _serve_prompts(probed) == _serve_prompts(bare)
    assert q.probes > 0 and q.recon_passes > 0


def test_record_replay_bit_identical_in_bf16(dev, tmp_path):
    """The controller (an impossible TPOT target) with preemption on the
    card in bf16: the recording replays into a fresh engine sharing the
    params, every token, rung and decision equal, nothing built after
    warmup."""
    from repro_torch import obs
    from repro_torch.obs.flight import replay
    from repro_torch.serving import SchedulerConfig, SLOConfig
    sink = str(tmp_path / "f.jsonl")
    kw = dict(slo=SLOConfig(tpot_p95=1e-9, max_queue=2),
              scheduler=SchedulerConfig(max_queue=8, preemption=True),
              rung=0)
    fr = obs.FlightRecorder(sink=sink)
    eng, params = _bf16_ladder_engine(dev, obs.Telemetry(flight=fr),
                                      **dict(kw))
    rng = np.random.default_rng(7)
    with eng:
        for L in (20, 33, 17, 12):
            eng.submit(rng.integers(0, 256, L), 24,
                       priority="best-effort")
        for _ in range(12):
            eng.step()
        eng.submit(rng.integers(0, 256, 9), 8, priority="interactive")
        eng.run()
    kinds = {r["kind"] for r in fr.records("decision")}
    assert {"rung_switch", "preempt", "resume"} <= kinds
    report = replay.replay(sink, engine_factory=lambda clock, tel: Engine(
        params, eng.cfg, eng.ecfg, ladder=eng.ladder, device=dev,
        telemetry=tel, clock=clock))
    assert report.ok, report.failures
    assert report.requests == 5
    assert all(v == 0 for v in report.retraces.values())


# -- training -----------------------------------------------------------------

def _train_step_on(device, cfg, params_cpu, toks, ocfg, remat="none"):
    from repro_torch.launch.train import deterministic
    from repro_torch.optim import adamw
    params = P.tree_map(lambda t: t.to(device, copy=True), params_cpu)
    opt = adamw.init(params, ocfg)
    step = api.make_train_step(cfg, ocfg, remat=remat)
    with deterministic():
        params, opt, met = step(params, opt, {"tokens": toks.to(device)})
    return params, {k: float(v) for k, v in met.items()}


def test_train_step_on_card_equals_cpu(dev):
    """One train step of reduced llama31_8b (f32, TF32 off) from the same
    weights on the card and on the CPU: loss at 1e-5, grad norm at 1e-4
    and every updated param at the CPU parity tests' tolerances
    (``tests/test_torch_train.py``, eps 1e-3 as there); on the card,
    remat ``dots`` and ``full`` give params bit-equal to ``none``."""
    from repro_torch.optim import adamw
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 48)))
    ocfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=1, decay_steps=4,
                             eps=1e-3)
    pc, mc = _train_step_on("cpu", cfg, params, toks, ocfg)
    pg, mg = _train_step_on(dev, cfg, params, toks, ocfg)
    assert abs(mg["loss"] - mc["loss"]) <= 1e-5
    np.testing.assert_allclose(mg["grad_norm"], mc["grad_norm"], rtol=1e-4)
    assert mg["lr"] == mc["lr"]
    for (path, g), (_, c) in zip(P.tree_flatten_with_path(pg),
                                 P.tree_flatten_with_path(pc)):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
    for remat in ("dots", "full"):
        pr, mr = _train_step_on(dev, cfg, params, toks, ocfg, remat)
        assert mr["loss"] == mg["loss"]
        for a, b in zip(P.tree_leaves(pr), P.tree_leaves(pg)):
            assert torch.equal(a, b), remat


def test_bf16_grads_on_card_match_cpu(dev):
    """Reduced gemma2_2b in bf16 (tied, softcapped head): the card takes
    the head's f32-output product and its hand-written backward
    (``model._HeadProduct``), the CPU an f32 product; the loss agrees at
    the bf16 tolerance 3e-2 and each grad leaf within 3e-2 of its norm."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("gemma2_2b")),
                              dtype="bfloat16")
    params = api.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    out = {}
    for d in ("cpu", dev):
        p = P.tree_map(lambda t: t.to(d, copy=True), params)
        leaves = P.tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = api.make_loss_fn(cfg)(p, {"tokens": toks.to(d)})
        grads = torch.autograd.grad(loss, leaves)
        out[str(d)] = (float(loss), [g.float().cpu() for g in grads])
    (lc, gc_), (lg, gg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 3e-2
    for a, b in zip(gg, gc_):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert float((a - b).norm()) <= 3e-2 * float(b.norm()) + 1e-12


def test_head_product_on_card_multiplies_the_f32_cotangent(dev):
    """``model._HeadProduct`` on the card (bf16 operands, f32 logits;
    40000 vocab columns: two chunks, the second ragged) against the f32
    cotangent times the operands on the CPU: each grad within 1e-4 of its
    norm, where rounding the cotangent to bf16 misses by more."""
    from repro_torch.models import model as M
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((512, 256))).bfloat16()
    w = torch.from_numpy(rng.standard_normal((256, 40000))).bfloat16()
    g = torch.from_numpy(rng.standard_normal((512, 40000)) * 2.0 ** rng.uniform(
        -20, 20, (512, 40000))).float()
    xg, wg = (t.to(dev).requires_grad_(True) for t in (x, w))
    y = M._HeadProduct.apply(xg, wg)
    torch.testing.assert_close(y.cpu(), x.float() @ w.float(), rtol=1e-5,
                               atol=1e-4)
    got = torch.autograd.grad(y, (xg, wg), g.to(dev))
    want = ((g @ w.float().T).bfloat16(), (x.float().T @ g).bfloat16())
    gb = g.bfloat16().float()
    cast = ((gb @ w.float().T).bfloat16(), (x.float().T @ gb).bfloat16())
    for a, b, c in zip(got, want, cast):
        assert a.dtype == torch.bfloat16
        norm = float(b.float().norm())
        assert float((a.cpu().float() - b.float()).norm()) <= 1e-4 * norm
        assert float((c.float() - b.float()).norm()) > 1e-4 * norm


def test_preempted_train_on_card_equals_uninterrupted(dev, tmp_path):
    """``train()`` on the card through the runner, checkpoints every 5
    steps, preempted at steps 7 and 21, against an uninterrupted run:
    every param bit-equal (``train``'s deterministic kernels), and the
    deterministic mode is off again after."""
    from repro_torch.launch.train import train
    kw = dict(arch="llama31_8b", use_reduced=True, steps=24, batch=8,
              seq=96, lr=5e-3, ckpt_every=5, device=dev,
              log=lambda *a: None)
    a = train(**kw, ckpt_dir=str(tmp_path / "a"))
    b = train(**kw, ckpt_dir=str(tmp_path / "b"), fail_at=(7, 21))
    assert len(b[3]) == len(a[3]) + 3
    for x, y in zip(P.tree_leaves(a[0]), P.tree_leaves(b[0])):
        assert x.is_cuda and torch.equal(x, y)
    assert a[4] == b[4]
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("arch", ["whisper_large_v3", "internvl2_26b"])
def test_reduced_multimodal_on_card_matches_cpu(dev, arch):
    """Reduced whisper (frames, cross-attention) and internvl2 (patch
    prefix) from the CPU's init: the card's prefill-then-decode greedy
    tokens equal the CPU's under off, mask and pallas, and a whisper plan
    calibrated on the CPU serves the CPU's tokens on the card
    (``chip_smoke.reduced_multimodal_check`` raises otherwise)."""
    out = chip_smoke.reduced_multimodal_check(dev, arch)
    assert set(out["distinct_tokens"]) == {"off", "mask", "pallas"}


@pytest.mark.parametrize("model,layer,rows", [
    ("whisper_large_v3", [("mlp/wi", 1280, 5120), ("cross/wk", 1280, 1280)],
     [8, 1500]),
    ("internvl2_26b", [("mlp/wo", 16384, 6144), ("attn/wk", 6144, 1024)],
     [8, 32])])
def test_kernels_at_multimodal_shapes(dev, model, layer, rows):
    """score_select, then sparse_matmul_shared on its kept blocks, at a
    whisper and an internvl2 projection shape (bf16, tau -inf and
    finite, no row weights): against their plain versions, two launches
    bit-equal (``chip_smoke.whole_prefill_kernels`` raises otherwise)."""
    errs = chip_smoke.whole_prefill_kernels(K, ref, dev, rows, layer=layer,
                                            model=model)
    assert set(errs) == {"score_select", "sparse_matmul_shared"}


def _legacy_model(arch, dev):
    """A reduced ``arch`` from the CPU's init (Gemma and whisper weights
    scaled by ``GEMMA_WEIGHT_SCALE``, else they repeat one token) on the
    card, its sp tree at keep 0.5 and tau -inf, ``pallas`` at block 16."""
    cfg = reduced(get_config(arch))
    params = api.init_model(cfg, 0, device="cpu")
    if arch.startswith(("gemma", "whisper")):
        params = chip_smoke.scale_gemma_weights(params)
    params = P.tree_map(lambda t: t.to(dev), params)
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    return cfg, params, sp, SparsityPolicy.uniform("pallas", k_max_frac=0.5,
                                                   block=16)


@pytest.mark.parametrize("arch,S,gen", [("gemma2_2b", 24, 16),
                                        ("mamba2_130m", 16, 8)])
def test_legacy_generate_graph_equals_eager_on_card(dev, arch, S, gen):
    """``serve.generate`` on the card, its decode step a CUDA graph built
    once per call, under uncalibrated ``pallas``: the eager loop's tokens
    (a dense prefill, then ``api.make_decode_step``), the same tokens
    from a second call, and each kernel launched once per projection in
    the warm call and in each of ``gen - 1`` replays
    (``chip_smoke.legacy_run`` raises otherwise); gemma2's 32-position
    windows roll."""
    from repro_torch.launch import serve
    cfg, params, sp, pol = _legacy_model(arch, dev)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, S))).to(dev)
    runs = [chip_smoke.legacy_run(f"{arch} legacy", serve, params, cfg,
                                  prompts, gen, pol, sp, K, "the card")
            for _ in range(2)]
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    eager = chip_smoke.generate(
        params, cfg, prompts, gen, policy=pol.for_phase("decode"), sp=sp,
        prefill=(pol.for_phase("prefill_dense"), None))
    assert torch.equal(eager, runs[0]["tokens"])
    assert runs[0]["launches"] == gen * chip_smoke.pass_launches(cfg)[
        "score_select"] > 0


def test_batch_decode_steps_on_card_equal_eager_for_whisper(dev):
    """Reduced whisper with frames through one ``BatchDecodeSteps`` of
    three keys (dense, ``mask``, ``pallas``; each built once): the
    graph's tokens equal the eager loop's per mode, and the ``pallas``
    graph records one launch of each kernel per decode projection."""
    from repro_torch.serving.graphs import BatchDecodeSteps
    cfg, params, sp, pol = _legacy_model("whisper_large_v3", dev)
    B, S, gen = 2, 12, 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    frames = chip_smoke.multimodal_inputs(cfg, B, dev, 0)
    keys = [(SparsityPolicy.dense(), None),
            (SparsityPolicy.uniform("mask"), sp), (pol, sp)]
    steps = BatchDecodeSteps(cfg, params, keys, B, S + gen, dev)
    for i, (policy, s) in enumerate(keys):
        for _ in range(2):
            got = chip_smoke.generate(params, cfg, toks, gen, policy=policy,
                                      sp=s, steps=steps, key=i, **frames)
        want = chip_smoke.generate(params, cfg, toks, gen, policy=policy,
                                   sp=s, **frames)
        assert torch.equal(got, want)
    assert steps.builds == 3 and steps.steps == [2 * (gen - 1)] * 3
    dec = chip_smoke.multimodal_passes(cfg)[1]
    assert {k: v for k, v in steps.captured[2].items() if v} == {
        "score_select": dec, "sparse_matmul_shared": dec}


@pytest.mark.parametrize("arch", ["gemma2_2b", "mamba2_130m"])
def test_batch_decode_build_on_filled_caches_leaves_them(dev, arch):
    """A ``BatchDecodeSteps`` build on caches already holding a prompt:
    its warm call writes a rolling window's live column and advances
    every SSM state, and the build puts all of it back bit for bit."""
    from repro_torch.serving.graphs import BatchDecodeSteps
    cfg, params, sp, pol = _legacy_model(arch, dev)
    steps = BatchDecodeSteps(cfg, params, [(pol, sp)], 4, 40, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for leaf in P.tree_leaves(steps.caches):
        leaf.copy_(torch.randn(leaf.shape, device=dev, generator=gen))
    before = [t.clone() for t in P.tree_leaves(steps.caches)]
    steps.build(0)
    torch.cuda.synchronize()
    assert steps.builds == 1 and steps.captured[0]
    for a, b in zip(before, P.tree_leaves(steps.caches), strict=True):
        assert torch.equal(a, b)


@pytest.fixture
def host_mesh(dev):
    """A 1x1 mesh over an NCCL group of one rank (chip_smoke's phase 22
    group), destroyed after the test."""
    from repro_torch.launch.mesh import make_host_mesh
    with chip_smoke.single_rank_group(dev):
        yield make_host_mesh("cuda")


def test_host_mesh_serve_equals_unsharded_on_card(dev, host_mesh):
    """Reduced llama31_8b (bf16) placed by LOGICAL_RULES_SERVE on a 1x1
    mesh of the card: prefill and aligned decode under uncalibrated
    ``pallas`` give the unsharded run's tokens and logits, and launch
    each kernel once per projection per pass, as unsharded
    (``chip_smoke.sharded_serve_check`` raises otherwise)."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("llama31_8b")),
                              dtype="bfloat16", d_model=256, num_heads=4,
                              head_dim=64, d_ff=512)
    params = api.init_model(cfg, 0, device=dev)
    res = chip_smoke.sharded_serve_check(dev, K, host_mesh, cfg, params)
    assert res["tokens_equal"] and res["logit_max_diff"] <= \
        chip_smoke.SHARD_TOL
    assert res["launches_per_pass"] == \
        chip_smoke.pass_launches(cfg)["score_select"] > 0


def test_restore_under_context_on_card(dev, host_mesh, tmp_path):
    """A checkpoint restored inside a context lands on the card as
    DTensors laid out by the rules, holding the saved values; the
    sharded train step's loss and params equal the unsharded step's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as sh
    cfg = reduced(get_config("granite_moe_1b_a400m"))
    params = api.init_model(cfg, 0, device=dev)
    _, axes, _ = api.abstract_model(cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params)
    with sh.sharding_context(host_mesh, sh.LOGICAL_RULES_TRAIN) as ctx:
        got, _ = mgr.restore(params, axes_tree=axes)
        for (path, ax), leaf in zip(sh.axes_leaves(axes),
                                    P.tree_leaves(got), strict=True):
            want = dict(P.tree_flatten_with_path(params))[path]
            assert leaf.device_mesh is host_mesh and leaf.is_cuda
            assert tuple(leaf.placements) == sh.named_sharding(
                ax, want.shape, ctx).placements
            assert torch.equal(leaf.full_tensor(), want)
    res = chip_smoke.sharded_train_check(dev, host_mesh, cfg)
    assert res["loss_diff"] <= 1e-5 and res["param_max_diff"] <= 1e-5


def test_analysis_global_passes_clean_on_card(dev):
    """``repro_torch.analysis``'s global passes on the card: the warmup
    set captured and replayed in place, every key stable, and every
    launch geometry inside the card's limits and equal to
    ``wisparse_launch_info``'s at every swept shape."""
    from repro_torch.analysis import run_global_passes
    from repro_torch.analysis.registry import global_passes
    root = str(pathlib.Path(__file__).resolve().parents[1])
    assert run_global_passes(root, device="cuda") == []
    rep = global_passes()["launch-geometry"].report
    assert rep["compared"] > 1000 and rep["min_active_clusters"] >= 1
    assert rep["limits"]["smem_optin"] >= max(rep["smem"].values())


@pytest.mark.parametrize("E,B,n,m", [(1, 8, 4096, 14336), (1, 448, 14336, 4096),
                                     (1, 13, 384, 131), (48, 8, 1536, 512),
                                     (1, 32, 128, 1), (48, 113, 1536, 512),
                                     (32, 32, 1024, 512), (16, 8, 4096, 14336),
                                     (16, 1, 14336, 4096)])
@pytest.mark.parametrize("elem", [2, 4])
def test_launch_info_equals_the_mirror(dev, E, B, n, m, elem):
    """``wisparse_launch_info`` (the geometry by the launches' own code)
    equals ``kernels/geometry.py``'s mirror for every kernel of the
    shape, at kb = 1, nb/2, nb, in both forms of the expert selection;
    every score_select cluster (or per-expert block) can run."""
    from repro_torch.kernels import geometry as G
    limits = G.launch_info("device")
    assert limits["threads"] >= 1024 and limits["smem_optin"] >= 232448
    blk = min(128, n)
    nb = n // blk
    for kb in sorted({1, max(1, nb // 2), nb}):
        kernels = [("sparse_matmul_shared_experts" if E > 1
                    else "sparse_matmul_shared", False)]
        if E == 1:
            kernels.append(("sparse_matmul_per_seq", True))
        for name, per_seq in kernels:
            plan = K.launch_plan(B, n, m, kb, blk, per_seq, elem, E)
            want = G.matmul_geometry(name, plan, B, n, m, blk, kb, elem)
            got, _ = G.launch_info(name, E, B, n, m, blk, kb, plan.rows,
                                   plan.cols, plan.splits, elem)
            assert got == want, (name, kb)
        name = "score_select_experts" if E > 1 else "score_select"
        for aligned in (True, False):
            want = G.score_select_geometry(E, B, n, blk, kb, elem, aligned,
                                           limits["sms"], E > 1)
            got, active = G.launch_info(name, E, B, n, 0, blk, kb, 0, 0, 0,
                                        elem, aligned)
            assert got == want and active >= 1, (name, kb, aligned)


@pytest.mark.parametrize("R", [63, 64, 65, 129])
@pytest.mark.parametrize("m", [384, 200])
def test_expert_matmul_tile_form(dev, R, m):
    """The expert entry's whole-prefill tile form (``csrc/sparse_matmul_
    tile.cu``: TMA ring, wgmma, 128-row tiles with a half-tile tail)
    against the plain version: 3 experts, n = 1024 (nb = 8), kb = 1,
    nb/2 and nb with a repeated id and ids clamped at both ends, within
    1e-4 + 1e-4 |ref|, two launches bit-equal.  The plan takes the tile
    form from ``TILE_MIN_ROWS`` rows on (R = 63 keeps the gather form),
    and the launch counts as a ``sparse_matmul_shared_experts`` and, in
    the tile form, in ``tile_launches``."""
    E, n, nb = 3, 1024, 8
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(E, R, n, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(E, n, m, device=dev, generator=gen) * 0.1).to(
        torch.bfloat16)
    for kb in (1, nb // 2, nb):
        idx = torch.randint(0, nb, (E, kb), device=dev, generator=gen).to(
            torch.int32)
        idx[0, -1] = idx[0, 0]          # a repeat (kb = 1: itself)
        idx[1, 0] = -3                  # clamped to 0
        idx[2, -1] = nb + 5             # clamped to nb - 1
        plan = K.expert_plan(R, n, m, kb, 128, 2, E)
        assert (plan.form == "tile") == (R >= K.TILE_MIN_ROWS >= 64)
        K.reset_launch_counts()
        y = K.sparse_matmul_shared_experts(x, w, idx)
        assert K.launch_counts["sparse_matmul_shared_experts"] == 1
        assert K.tile_launches["sparse_matmul_shared_experts"] == \
            int(plan.form == "tile")
        _close(y, ref.ref_sparse_matmul_shared_experts(x, w, idx, 128))
        assert torch.equal(y, K.sparse_matmul_shared_experts(x, w, idx))


@pytest.mark.parametrize("R", [111, 641])
def test_expert_matmul_tile_form_at_jamba_shapes(dev, R):
    """jamba_v01_52b's three expert projections (16 experts, 50% kept)
    at the whole-prefill capacities of a 704- and a 4096-token prompt:
    the tile form within 1e-4 + 1e-4 |ref| of the plain version and of
    the gather form's own result (``launch_plan``'s, through the C
    entry), two launches bit-equal."""
    from repro_torch.kernels import build
    gen = torch.Generator(device=dev).manual_seed(32)
    lib = build.library()
    for n, m in ((4096, 14336), (14336, 4096)):
        E, nb = 16, n // 128
        kb = nb // 2
        x = torch.randn(E, R, n, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(E, n, m, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        idx = torch.stack([torch.randperm(nb, device=dev, generator=gen)[:kb]
                           for _ in range(E)]).to(torch.int32)
        assert K.expert_plan(R, n, m, kb, 128, 2, E).form == "tile"
        y = K.sparse_matmul_shared_experts(x, w, idx)
        _close(y, ref.ref_sparse_matmul_shared_experts(x, w, idx, 128))
        assert torch.equal(y, K.sparse_matmul_shared_experts(x, w, idx))
        plan = K.launch_plan(R, n, m, kb, 128, False, 2, E)
        ws, cnt = K.matmul_scratch(plan, dev)
        yg = torch.empty_like(y)
        err = lib.wisparse_sparse_matmul_shared_experts(
            x.data_ptr(), w.data_ptr(), idx.data_ptr(), yg.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if cnt is None else cnt.data_ptr(), E, R, n, m, 128, kb,
            plan.rows, plan.cols, plan.splits, 1,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0
        _close(y, yg)


def test_expert_matmul_tile_form_refusal_raises(dev, monkeypatch):
    """No fallback: a tile plan the C entry refuses (f32 operands) raises
    from the wrapper and counts no launch."""
    tile = K.expert_plan(641, 256, 128, 2, 128, 2, 2)
    assert tile.form == "tile"
    monkeypatch.setattr(K, "expert_plan", lambda *a, **k: tile)
    x = torch.randn(2, 641, 256, device=dev)
    w = torch.randn(2, 256, 128, device=dev)
    idx = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        K.sparse_matmul_shared_experts(x, w, idx)
    assert K.launch_counts["sparse_matmul_shared_experts"] == 0


@pytest.mark.parametrize("E,R,n,m", [(16, 641, 4096, 14336),
                                     (16, 641, 14336, 4096),
                                     (48, 113, 1536, 512), (3, 65, 1024, 200),
                                     (1, 4096, 4096, 14336)])
def test_launch_info_equals_the_mirror_in_the_tile_form(dev, E, R, n, m):
    """``wisparse_launch_info`` for the expert entry's tile plans (the
    persistent grid over the card's SMs, 384 threads, the ring's shared
    memory, form "tile") equals ``matmul_geometry``'s mirror."""
    from repro_torch.kernels import geometry as G
    limits = G.launch_info("device")
    nb = n // 128
    for kb in sorted({1, max(1, nb // 2), nb}):
        plan = K.expert_plan(R, n, m, kb, 128, 2, E)
        want = G.matmul_geometry("sparse_matmul_shared_experts", plan, R, n,
                                 m, 128, kb, 2, limits["sms"])
        got, _ = G.launch_info("sparse_matmul_shared_experts", E, R, n, m,
                               128, kb, plan.rows, plan.cols, plan.splits, 2)
        assert want.form == "tile" and got == want, kb
        assert want.smem <= limits["smem_optin"]
