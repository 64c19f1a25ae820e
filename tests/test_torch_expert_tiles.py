"""The whole-prefill tile form of the expert-batched block-gather matmul
(``csrc/sparse_matmul_tile.cu``), on the CPU: its plan, the walk of its
persistent CTAs, its launch geometry against the CUDA source, the
launch-geometry pass over whole-prefill expert rows, and the expert
wrapper against JAX's ``vmap`` of the Pallas kernel at such rows.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 3).  JAX parity: f32, 1e-5, as
``tests/test_torch_kernels.py`` holds the same kernel."""
import itertools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sparse_matmul as JK
from repro_torch.analysis.registry import global_passes
from repro_torch.kernels import build
from repro_torch.kernels import geometry as G
from repro_torch.kernels import sparse_matmul as K
from torch_threads import one_thread_module  # noqa: F401 (autouse)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

# (E, R, n, m, kb): jamba_v01_52b's expert projections at whole-prefill
# capacities (4096 tokens: 641; 704: 111), granite_moe_3b_a800m's at a
# 448-token chunk, an awkward m under one column tile, one expert at a
# 4096-row prefill (the 2-D evidence shape) and a row count just at the
# threshold
TILE_SHAPES = [(16, 641, 4096, 14336, 16), (16, 641, 14336, 4096, 56),
               (16, 111, 4096, 14336, 1), (48, 113, 1536, 512, 6),
               (3, 65, 1024, 200, 8), (1, 4096, 4096, 14336, 32),
               (5, K.TILE_MIN_ROWS, 256, 8, 2)]


@pytest.mark.parametrize("E,R,n,m,kb", TILE_SHAPES)
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_tile_plan_walks_every_tile_once(E, R, n, m, kb, sms):
    """The tile form's plan: one slice over every kept position, no
    split-K workspace or counters (the scratch is not touched), and its
    persistent CTAs visit each (expert, row tile, column tile) exactly
    once, at most one CTA per SM and at most 65535 of them."""
    plan = K.expert_plan(R, n, m, kb, 128, 2, E)
    assert plan.form == "tile"
    assert (plan.rows, plan.cols, plan.splits) == (K.TILE_ROWS,
                                                   K.TILE_WIDE, 1)
    assert list(plan.slice(0)) == list(range(kb))
    assert plan.workspace == 0 and plan.counters == 0
    assert K.matmul_scratch(plan, "cpu") == (None, None)
    rows, cols = K.TILE_ROWS, K.TILE_WIDE
    assert plan.tiles_b * rows >= R > (plan.tiles_b - 1) * rows
    assert plan.tiles_m * cols >= m > (plan.tiles_m - 1) * cols
    walk = G.tile_walk(plan, sms)
    assert 1 <= len(walk) == G.tile_ctas(plan, sms) <= min(sms, 65535)
    assert all(walk)                       # no CTA without a tile
    visited = list(itertools.chain.from_iterable(walk))
    assert sorted(visited) == list(itertools.product(
        range(E), range(plan.tiles_b), range(plan.tiles_m)))
    # row tile fastest: each CTA's tiles in increasing linear order
    for tiles in walk:
        lin = [(e * plan.tiles_m + c) * plan.tiles_b + r
               for e, r, c in tiles]
        assert lin == sorted(lin)


@pytest.mark.parametrize("R,tiles_b", [(641, 6), (241, 2), (111, 1),
                                       (1300, 11)])
def test_tile_ctas_share_the_ragged_tail(R, tiles_b):
    """Where the CTAs walk several tiles each, their count is coprime with
    the row tiles, so every CTA meets each row tile (the ragged tail's
    cheaper one too) in turn, not always the same one."""
    plan = K.expert_plan(R, 4096, 14336, 16, 128, 2, 16)
    assert plan.tiles_b == tiles_b
    g = G.tile_ctas(plan, 132)
    assert 132 - 4 <= g <= 132
    if tiles_b > 1:
        assert math.gcd(g, tiles_b) == 1
        for tiles in G.tile_walk(plan, 132):
            rows = [r for _e, r, _c in tiles]
            assert len(set(rows)) == min(len(rows), tiles_b)


@pytest.mark.parametrize("E,R,n,m,kb,elem,aligned", [
    (16, 8, 4096, 14336, 16, 2, True),       # jamba decode
    (48, 9, 512, 1536, 2, 2, True),          # granite chunk
    (4, 40, 256, 128, 2, 2, True),           # split-K
    (3, 33, 1024, 256, 7, 2, True),
    (16, K.TILE_MIN_ROWS - 1, 4096, 14336, 16, 2, True),
    (16, 641, 4096, 14336, 16, 4, True),     # f32
    (16, 641, 4096, 14336, 16, 2, False),    # unaligned x or w
    (5, 641, 384, 131, 2, 2, True),          # m not a multiple of 8
    (16, 641, 4096, 14336, 16, 2, True)])    # the tile form, for contrast
def test_expert_plan_is_the_gather_plan_outside_the_tile_form(
        E, R, n, m, kb, elem, aligned):
    """Below the row threshold, in f32, for unaligned operands or an m the
    tensor maps cannot stride, the expert entry's plan is
    ``launch_plan``'s exactly."""
    plan = K.expert_plan(R, n, m, kb, 128, elem, E, aligned)
    gather = K.launch_plan(R, n, m, kb, 128, False, elem, E)
    if elem == 2 and aligned and R >= K.TILE_MIN_ROWS and m % 8 == 0:
        assert plan.form == "tile" and gather.form == "gather"
    else:
        assert plan == gather and plan.form == "gather"


@pytest.mark.parametrize("blk", [16, 32, 96])
def test_expert_plan_needs_whole_64_channel_halves(blk):
    """A kept block the TMA ring cannot stream in 64-channel halves keeps
    the gather form."""
    n = 12 * blk
    assert K.expert_plan(641, n, 512, 4, blk, 2, 16) == \
        K.launch_plan(641, n, 512, 4, blk, False, 2, 16)
    assert K.expert_plan(641, 12 * 128, 512, 4, 128, 2, 16).form == "tile"


@pytest.mark.parametrize("E,R,n,m,kb", TILE_SHAPES)
def test_tile_geometry_within_the_card_limits(E, R, n, m, kb):
    """``matmul_geometry`` of the tile form: the persistent grid, 384
    threads and the ring's shared memory, within an H100's limits, and
    refused (``ok`` False) for what the C entry refuses."""
    lim = G.H100_LIMITS
    plan = K.expert_plan(R, n, m, kb, 128, 2, E)
    geo = G.matmul_geometry("sparse_matmul_shared_experts", plan, R, n, m,
                            128, kb, 2, lim["sms"])
    assert geo.ok and geo.form == "tile"
    assert geo.grid == (G.tile_ctas(plan, lim["sms"]), 1, 1)
    assert geo.threads == G.TILE_THREADS <= lim["threads"]
    assert geo.smem == G.matmul_smem(2, K.TILE_ROWS, False) <= \
        lim["smem_optin"]
    assert geo.cluster == (1, 1, 1)
    # worked by hand: 4 stages of (128 + 256) x 64 bf16, the alignment
    # slack, 8 mbarriers, 128 ids
    assert geo.smem == 4 * (128 * 64 + 64 * 256) * 2 + 1024 + 64 + 512
    f32 = G.matmul_geometry("sparse_matmul_shared_experts", plan, R, n, m,
                            128, kb, 4, lim["sms"])
    per_seq = G.matmul_geometry("sparse_matmul_per_seq", plan, R, n, m, 128,
                                kb, 2, lim["sms"])
    assert not f32.ok and not per_seq.ok


def test_tile_mirror_constants_match_the_cuda_source():
    src = (build.CSRC / "sparse_matmul_tile.cuh").read_text()

    def const(name):
        (v,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(v)

    assert const("kRows") == K.TILE_ROWS
    assert const("kCols") == K.TILE_WIDE
    assert const("kDepth") == K.TILE_DEPTH
    assert const("kStages") == G.TILE_STAGES
    assert const("kThreads") == G.TILE_THREADS
    assert const("kMaxIds") == G.TILE_MAX_IDS
    assert (build.CSRC / "sparse_matmul_tile.cu").exists()
    entry = (build.CSRC / "sparse_matmul_shared.cu").read_text()
    assert "if (rows == tile::kRows) {" in entry


def test_launch_geometry_sweeps_whole_prefill_expert_rows():
    """The pass sweeps the expert rows of each served whole-prefill
    length (jamba_v01_52b's 4096-token prompt: 641), where the tile form
    runs, and reports both matmul forms with no finding."""
    p = global_passes()["launch-geometry"]
    shapes = set(p.shapes())
    assert (641, 4096, 14336, 128, 2, 16) in shapes
    assert (641, 14336, 4096, 128, 2, 16) in shapes
    assert {s[0] for s in shapes if s[5] == 16} >= {
        641, 241, 111, 221, 491, 371, 461, 271}
    assert p.run(REPO, "cpu") == []
    assert p.report["matmul_forms"] == ["gather", "tile"]
    assert p.report["smem"]["sparse_matmul_shared_experts"] == \
        G.matmul_smem(2, K.TILE_ROWS, False)


def test_launch_geometry_catches_a_tile_walk_that_skips_a_tile(monkeypatch):
    walk = G.tile_walk

    def skipping(plan, sms=132):
        out = walk(plan, sms)
        return [tiles[1:] if b == 0 else tiles for b, tiles in enumerate(out)]

    monkeypatch.setattr(G, "tile_walk", skipping)
    findings = global_passes()["launch-geometry"].run(REPO, "cpu")
    assert "sparse_matmul_shared_experts tile walk" in {
        f.snippet for f in findings}


@pytest.mark.parametrize("R,m,kb", [(65, 200, 2), (129, 384, 4)])
def test_expert_wrapper_matches_jax_vmap_at_whole_prefill_rows(R, m, kb):
    """At rows where the card takes the tile form, the expert wrapper on
    CPU tensors (the plain version) equals the Pallas kernel under
    ``jax.vmap`` over experts (interpret mode), with a repeated id; no
    kernel launch is counted."""
    E, n, blk = 3, 512, 128
    rng = np.random.default_rng(31)
    x = rng.standard_normal((E, R, n)).astype(np.float32)
    w = (rng.standard_normal((E, n, m)) * 0.1).astype(np.float32)
    idx = rng.integers(0, n // blk, (E, kb)).astype(np.int32)
    idx[0, -1] = idx[0, 0]
    want = jax.vmap(lambda xe, we, ie: JK.sparse_matmul_shared(
        xe, we, ie, blk=blk, interpret=True))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx))
    K.reset_launch_counts()
    got = K.sparse_matmul_shared_experts(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(idx), blk=blk)
    assert K.expert_plan(R, n, m, kb, blk, 2, E).form == "tile"
    assert got.shape == (E, R, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not any(K.launch_counts.values())
    assert not any(K.tile_launches.values())
