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
from repro_torch.kernels import ref
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
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device="cpu")
    sp = default_sp_stacked(params, cfg, keep_frac=0.5, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=0.5, block=16)
    prompts = [np.random.default_rng(1).integers(0, 256, n) for n in (20, 9)]
    outs = []
    for d in (dev, torch.device("cpu")):
        eng = Engine(
            P.tree_map(lambda t, d=d: t.to(d), params), cfg,
            EngineConfig(max_slots=2, max_len=64, prefill_chunk=16,
                         policy=pol), P.tree_map(lambda t, d=d: t.to(d), sp),
            device=d)
        for p in prompts:
            eng.submit(p, 4)
        K.reset_launch_counts()
        outs.append(eng.run())
        if d.type == "cuda":
            steps = eng.stats.decode_steps + eng.stats.prefill_sparse_chunks
            assert K.launch_counts == {
                "score_mask": 7 * cfg.num_layers * steps,
                "sparse_matmul_shared": 7 * cfg.num_layers * steps,
                "sparse_matmul_per_seq": 0}
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
