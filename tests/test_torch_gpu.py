"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA card (decided inside the
test, never at import).  On a machine with one, without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: kernel and plain version both upcast to f32 exactly and
accumulate in f32, so they differ only in summation order (1e-4)."""
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
                assert steps.captured[i] == {"score_select": per,
                                             "sparse_matmul_shared": per,
                                             "sparse_matmul_per_seq": 0}
            assert eng.launches(K.launch_counts) == {
                "score_select": per * ran, "sparse_matmul_shared": per * ran,
                "sparse_matmul_per_seq": 0}
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
