"""The whole-prefill forms of the two 2-D kernels and of the expert
selection, on the CPU: the shared matmul's plan (``expert_plan`` at one
expert: the TMA + wgmma tile form of ``csrc/sparse_matmul_tile.cu`` from
``TILE_MIN_ROWS`` rows where the output has ``TILE_MIN_TILES_2D`` tiles,
else ``launch_plan``'s gather form exactly), ``score_select``'s form
(``score_form``: the spread form of ``csrc/score_select.cu`` from
``SCORE_SPREAD_MIN_ROWS`` rows, else one cluster), the route of
``score_select_experts`` (one block per expert, the same spread form with
the expert axis in its grid from ``SCORE_EXPERT_SPREAD_MIN_ROWS`` rows per
expert, else one cluster per expert), the spread form's geometry and the
mirror's constants against the CUDA source, what the wrappers pass their
C entries (a stub library: no nvcc), and ``wisparse_project`` and
``wisparse_project_experts`` against the JAX ``pallas`` projection at
whole-prefill shapes.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  JAX parity: f32 1e-5 and bf16 3e-2, as
``tests/test_kernels.py`` uses for the same kernels; the inputs are
tie-free (no score within 0.1% of tau)."""
import ctypes
import itertools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sparse_matmul as JK
from repro_torch.kernels import build
from repro_torch.kernels import geometry as G
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_matmul as K
from torch_threads import one_thread_module  # noqa: F401 (autouse)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

# (B, n, m): whole-prefill rows of the archs served whole at published
# width (jamba_v01_52b's 4096-token prompt, a prime 4099, gemma2_2b's 2 x
# 4326, mamba2_130m's 3 x 8192, whisper_large_v3's cross wk/wv over 1500
# and 6000 frames, jamba's and mamba2's narrow projections at 4096 and
# 24,576 rows) and the thresholds themselves: 64 rows of 9 column tiles,
# 9 row tiles of one column tile
WHOLE = [(4096, 4096, 14336), (4096, 14336, 4096), (4099, 4096, 8192),
         (8652, 2304, 9216), (24576, 768, 1536), (1500, 1280, 1280),
         (6000, 1280, 1280), (4096, 4096, 16), (24576, 768, 24),
         (K.TILE_MIN_ROWS, 4096, 2304),
         (K.TILE_ROWS * (K.TILE_MIN_TILES_2D - 1) + 1, 4096, 128)]


@pytest.mark.parametrize("B,n,m", WHOLE)
def test_2d_plan_takes_the_tile_form_from_the_threshold(B, n, m):
    """At whole-prefill rows the 2-D entry's plan is the tile form: one
    slice over every kept position, no split-K scratch, 128 x 256 tiles
    covering (B, m); its persistent CTAs walk each tile once."""
    kb = n // 256
    plan = K.expert_plan(B, n, m, kb, 128, 2, 1)
    assert plan.form == "tile" and plan.experts == 1
    assert (plan.rows, plan.cols, plan.splits) == (K.TILE_ROWS,
                                                   K.TILE_WIDE, 1)
    assert plan.workspace == 0 and plan.counters == 0
    assert list(plan.slice(0)) == list(range(kb))
    assert plan.tiles_b * K.TILE_ROWS >= B > (plan.tiles_b - 1) * K.TILE_ROWS
    assert plan.tiles_m * K.TILE_WIDE >= m > (plan.tiles_m - 1) * K.TILE_WIDE
    walk = G.tile_walk(plan, 132)
    assert sorted(itertools.chain.from_iterable(walk)) == list(
        itertools.product([0], range(plan.tiles_b), range(plan.tiles_m)))


@pytest.mark.parametrize("B,n,m,blk,elem,aligned", [
    (K.TILE_MIN_ROWS - 1, 4096, 14336, 128, 2, True),   # below the rows
    (8, 4096, 14336, 128, 2, True),          # decode, 8 slots
    (24, 4096, 14336, 128, 2, True),         # a verify window
    (32, 4096, 14336, 128, 2, True),         # a prefill chunk
    (4096, 4096, 14336, 128, 4, True),       # f32
    (4096, 4096, 14336, 128, 2, False),      # x or w not 16-byte aligned
    (4096, 4096, 8 * 37 + 3, 128, 2, True),  # m not a multiple of 8
    (4096, 4096, 4096, 32, 2, True),         # blk not whole 64-ch halves
    (4096, 4096, 4096, 96, 2, True),
    (1024, 4096, 16, 128, 2, True),          # narrow m: 8 row tiles
    (1024, 4096, 128, 128, 2, True),
    (256, 4096, 1024, 128, 2, True),         # 2 x 4 tiles
    (256, 2304, 1024, 128, 2, True),
    (128, 5120, 1280, 128, 2, True),         # 1 x 5 tiles
    (64, 4096, 2048, 128, 2, True)])         # 1 x 8 tiles
def test_2d_plan_is_the_gather_plan_outside_the_tile_form(B, n, m, blk, elem,
                                                          aligned):
    """Below the row threshold, in f32, for unaligned operands, an m the
    tensor maps cannot stride, a blk the ring cannot stream in 64-channel
    halves, and an output of fewer than ``TILE_MIN_TILES_2D`` tiles (the
    width rule: a narrow m needs more rows), the 2-D plan is
    ``launch_plan``'s exactly."""
    n = n // blk * blk
    kb = max(1, n // blk // 2)
    plan = K.expert_plan(B, n, m, kb, blk, elem, 1, aligned)
    assert plan == K.launch_plan(B, n, m, kb, blk, False, elem)
    assert plan.form == "gather"


# the MoE archs served at published width, and the (groups, tokens per
# group) of each captured step of their engines: decode with 8 slots, a
# 32-token chunk, verify windows of 2-4 tokens per slot
MOE_ARCHS = ("granite_moe_1b_a400m", "granite_moe_3b_a800m", "jamba_v01_52b")
CAPTURED_STEPS = ((8, 1), (1, 32), (8, 2), (8, 3), (8, 4))


def test_serving_steps_keep_their_forms():
    """Decode (8 slots), verify (at most 24 rows) and chunk steps (32
    rows) are captured: every threshold lies above them, so no captured
    step changes form, the expert selection's route included (its rows
    per expert at those steps on every served MoE arch)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    assert K.TILE_MIN_ROWS >= 64
    assert K.SCORE_SPREAD_MIN_ROWS > 32
    for B in (1, 8, 24, 32):
        assert K.score_form(B, 4096, 128) == "cluster"
        assert K.expert_plan(B, 4096, 14336, 16, 128, 2, 1).form == "gather"
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        E = cfg.num_experts_padded
        for groups, tokens in CAPTURED_STEPS:
            R = moe.expert_rows(cfg, groups, tokens)
            assert R < K.SCORE_EXPERT_SPREAD_MIN_ROWS, (arch, groups, tokens)
            for n in (cfg.d_model, cfg.moe_d_ff):
                assert K.score_form(R, n, 128, 2, True, True) != "spread"
                geo = G.score_select_geometry(E, R, n, 128, 1, 2, True,
                                              experts=True)
                assert geo.form != "spread", (arch, R, n)


def test_reserved_scratch_holds_the_spread_workspace(monkeypatch):
    """``reserve_matmul_scratch`` at rows where the selection takes the
    spread form (an engine with many slots, whose captured decode step
    reaches it) reserves the workspace the spread launch is given, so a
    capture never allocates it; at decode rows of 8 slots it reserves
    nothing a one-slice plan does not need."""
    monkeypatch.setattr(K, "_scratch", {})
    K.reserve_matmul_scratch(9, 1536, 512, 128, "cpu", 2, 48)
    assert K.scratch_tensors("cpu") == (None, None)
    K.reserve_matmul_scratch(448, 1536, 512, 128, "cpu", 2, 48)
    ws, _ = K.scratch_tensors("cpu")
    assert ws is not None and ws.numel() >= K.MIN_WORKSPACE
    assert K.score_workspace("cpu") is ws


@pytest.mark.parametrize("B,n,elem,aligned,blk,want", [
    (K.SCORE_SPREAD_MIN_ROWS, 4096, 2, True, 128, "spread"),
    (K.SCORE_SPREAD_MIN_ROWS - 1, 4096, 2, True, 128, "cluster"),
    (4096, 14336, 2, True, 128, "spread"),
    (8652, 2304, 2, True, 128, "spread"),
    (24576, 768, 2, True, 128, "spread"),
    (6000, 1280, 4, True, 128, "spread"),     # f32: 32 lanes a block row
    (4096, 4096, 2, False, 128, "cluster"),   # x or xm unaligned
    (4096, 3000, 2, True, 100, "cluster"),    # blk not whole 16-byte units
    (4096, 96 * 40, 2, True, 96, "cluster"),  # 12 lanes do not divide 256
    (4096, 128 * 513, 2, True, 128, "cluster"),   # nb over the limit
    (448, 4096, 2, True, 128, "spread"),
    (32, 4096, 2, True, 128, "cluster")])
def test_score_form_at_whole_prefill_rows(B, n, elem, aligned, blk, want):
    """``score_form`` names the spread form exactly where the C entry's
    ``Geometry`` takes it, and the mirror's geometry agrees."""
    assert K.score_form(B, n, blk, elem, aligned) == want
    geo = G.score_select_geometry(1, B, n, blk, 1, elem, aligned)
    assert geo.form == want


@pytest.mark.parametrize("B,n,m", WHOLE + [(K.SCORE_SPREAD_MIN_ROWS, 4096, 1),
                                           (448, 14336, 1)])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_spread_geometry_within_the_card_limits(B, n, m, sms):
    """The spread form's grid of (channel block, row slab) blocks: slabs of
    whole row groups that cover B exactly once, about four blocks per SM,
    256 threads, a few KB of shared memory, no cluster, and partial sums
    that fit the workspace the wrapper passes."""
    lim = G.H100_LIMITS
    nb = n // 128
    geo = G.score_select_geometry(1, B, n, 128, nb // 2, 2, True, sms)
    slabs, rows = G.spread_slabs(B, nb, 128, 2, sms)
    assert geo.form == "spread" and geo.ok
    assert geo.grid == (nb, slabs, 1) and geo.cluster == (1, 1, 1)
    assert rows % (K.SCORE_SPREAD_THREADS // 16) == 0
    assert slabs * rows >= B > (slabs - 1) * rows
    assert nb * slabs < G.SCORE_SPREAD_PER_SM * sms + nb
    assert geo.threads == K.SCORE_SPREAD_THREADS <= lim["threads"]
    assert geo.smem == 4 * (128 + max(nb, G.SCORE_SPREAD_WARPS))
    assert geo.smem <= 48 * 1024 and slabs <= lim["grid_yz"]
    assert slabs * nb <= K.MIN_WORKSPACE


def test_spread_mirror_constants_match_the_cuda_source():
    src = (build.CSRC / "score_select.cu").read_text()

    def const(name):
        (v,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(v)

    assert const("kSpreadThreads") == K.SCORE_SPREAD_THREADS
    assert const("kSpreadPerSM") == G.SCORE_SPREAD_PER_SM
    assert const("kSpreadMinRows") == K.SCORE_SPREAD_MIN_ROWS
    assert const("kSpreadMaxBlocks") == K.SCORE_SPREAD_MAX_BLOCKS
    assert "constexpr int kSpreadWarps = kSpreadThreads / 32;" in src
    assert G.SCORE_SPREAD_WARPS == K.SCORE_SPREAD_THREADS // 32
    # the form codes launch_info reports: -1 for the spread form
    assert "constexpr int kSpreadForm = -2;" in src
    assert "geo.form + 1};" in src
    # the C entry's arguments: the workspace, its length and the form
    # after dtype
    assert len(build.SIGNATURES["wisparse_score_select"]) == 18


def test_expert_spread_mirror_constants_match_the_cuda_source():
    """The expert entry's spread threshold, its per-expert form tried
    first, its least rows per thread and slab, its grid with the expert
    axis in z, the workspace check over E x slabs x nb, and the C entry's
    workspace, length and form arguments."""
    src = (build.CSRC / "score_select.cu").read_text()

    def const(name):
        (v,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(v)

    assert const("kExpertSpreadMinRows") == K.SCORE_EXPERT_SPREAD_MIN_ROWS
    assert const("kSpreadUnroll") == G.SCORE_SPREAD_UNROLL
    assert "const int min_rows = experts ? kExpertSpreadMinRows : " \
        "kSpreadMinRows;" in src
    assert "const int least = experts ? rg * kSpreadUnroll : rg;" in src
    # the per-expert form is tried first, and only for the shape's own
    # form
    assert src.index("if (experts && want < 0 && kWide && blk == "
                     "kExpertBlk) {") < src.index("const int min_rows")
    assert "if (experts && want < 0 && kWide && blk == kExpertBlk) {" in src
    assert "const dim3 grid(geo.grid, geo.slabs, E);" in src
    assert "static_cast<long long>(E) * geo.slabs * (n / blk) > ws_len" in src
    assert "geo.form == kSpreadForm ? E : 1, geo.threads," in src
    sig = build.SIGNATURES["wisparse_score_select_experts"]
    assert len(sig) == 18 and sig[-4:-1] == (ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int)


# (R, n): jamba_v01_52b's expert rows at its whole prefills (704, 1536 and
# 4096 tokens: 111, 241, 641) and granite_moe_3b_a800m's at a 448-token
# group and 448 decode slots (113, 448), both input widths, and the
# threshold itself
EXPERT_SPREAD = [(641, 4096), (641, 14336), (241, 4096), (111, 14336),
                 (448, 1536), (448, 512), (113, 1536), (113, 512),
                 (K.SCORE_EXPERT_SPREAD_MIN_ROWS, 4096),
                 (K.SCORE_EXPERT_SPREAD_MIN_ROWS, 14336)]


@pytest.mark.parametrize("R,n", EXPERT_SPREAD)
@pytest.mark.parametrize("E", [16, 48])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_expert_spread_geometry_within_the_card_limits(R, n, E, sms):
    """The expert spread form's grid of (channel block, row slab, expert)
    blocks: slabs of whole row groups that cover each expert's R rows
    once, about four blocks per SM over the E x nb channel blocks, 256
    threads, a few KB of shared memory, no cluster, and E x slabs x nb
    partial sums that fit ``MIN_WORKSPACE``."""
    lim = G.H100_LIMITS
    nb = n // 128
    geo = G.score_select_geometry(E, R, n, 128, nb // 2, 2, True, sms,
                                  experts=True)
    slabs, rows = G.spread_slabs(R, nb, 128, 2, sms, E, experts=True)
    assert geo.form == "spread" and geo.ok
    assert geo.grid == (nb, slabs, E) and geo.cluster == (1, 1, 1)
    assert rows % (K.SCORE_SPREAD_THREADS // 16) == 0
    assert slabs * rows >= R > (slabs - 1) * rows
    # no more slabs than give each thread SCORE_SPREAD_UNROLL rows (16
    # row groups in bf16)
    assert slabs <= -(-R // (16 * G.SCORE_SPREAD_UNROLL))
    assert E * nb * slabs < G.SCORE_SPREAD_PER_SM * sms + E * nb
    assert geo.threads == K.SCORE_SPREAD_THREADS <= lim["threads"]
    assert geo.smem == 4 * (128 + max(nb, G.SCORE_SPREAD_WARPS))
    assert geo.smem <= 48 * 1024 and max(slabs, E) <= lim["grid_yz"]
    assert E * slabs * nb <= K.MIN_WORKSPACE
    if E * nb >= G.SCORE_SPREAD_PER_SM * sms:
        assert slabs == 1                  # the expert axis fills the card


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_route_by_the_rule(arch):
    """``score_select_experts``' route at each of the arch's expert
    shapes, decode and chunk rows up to a 4096-token whole prefill: the
    per-expert form wherever ``expert_config`` fits, else the spread form
    from ``SCORE_EXPERT_SPREAD_MIN_ROWS`` rows per expert, else one
    cluster per expert; the wrapper's twin (``score_form``) names the
    same form as the mirror, which the card holds against the C entry."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch)
    E = cfg.num_experts_padded
    rows = {moe.expert_rows(cfg, b, 1) for b in (1, 8, 32, 448)} | {
        moe.expert_rows(cfg, 1, t) for t in (32, 448, 704, 1536, 4096)}
    seen = set()
    for R in sorted(rows):
        for n in (cfg.d_model, cfg.moe_d_ff):
            geo = G.score_select_geometry(E, R, n, 128, 1, 2, True,
                                          experts=True)
            if G.expert_config(R, n, 128) is not None:
                want = "expert"
            elif R >= K.SCORE_EXPERT_SPREAD_MIN_ROWS:
                want = "spread"
            else:
                want = "cluster"
            assert geo.form.split()[0] == want, (R, n, geo)
            assert K.score_form(R, n, 128, 2, True, True) == want
            seen.add(want)
    assert "spread" in seen and "expert" in seen
    # jamba's decode rows at moe/wo (nb = 112) keep the cluster form
    if arch == "jamba_v01_52b":
        assert G.score_select_geometry(16, 8, 14336, 128, 56, 2, True,
                                       experts=True).form == "cluster"


MIN_E = K.SCORE_EXPERT_SPREAD_MIN_ROWS


@pytest.mark.parametrize("E,R,n,elem,aligned,blk,want", [
    (16, 641, 14336, 2, True, 128, "spread"),
    (16, MIN_E, 14336, 2, True, 128, "spread"),
    (16, MIN_E - 1, 14336, 2, True, 128, "cluster"),
    (16, MIN_E - 1, 4096, 2, True, 128, "cluster"),
    (48, MIN_E, 512, 2, True, 128, "expert"),   # the per-expert form first
    (48, MIN_E + 1, 512, 2, True, 128, "spread"),
    (16, 241, 4096, 4, True, 128, "spread"),    # f32: 32 lanes a block row
    (16, 17, 4096, 4, True, 128, "cluster"),    # f32 past the per-expert rows
    (16, 641, 4096, 2, False, 128, "cluster"),  # x or xm unaligned
    (4, 448, 96 * 40, 2, True, 96, "cluster"),  # 12 lanes do not divide 256
    (2, 448, 128 * 513, 2, True, 128, "cluster")])  # nb over the limit
def test_expert_score_form_at_the_edges_of_the_spread_form(
        E, R, n, elem, aligned, blk, want):
    """At the expert threshold and just below it, where the per-expert
    form holds the rows, in f32, unaligned, with a block row that does
    not divide the spread form's threads, or past its channel-block
    limit: the form the twin names is the mirror's."""
    assert K.score_form(R, n, blk, elem, aligned, True) == want
    geo = G.score_select_geometry(E, R, n, blk, 1, elem, aligned,
                                  experts=True)
    assert geo.form.split()[0] == want


def test_launch_geometry_catches_a_spread_workspace_shortfall(monkeypatch):
    """The static checker holds every spread launch's partial sums (E x
    slabs x nb) against the workspace: with a workspace of 64 values
    jamba's and granite's expert spread launches and the 2-D ones no
    longer fit, and the pass says so for both entries."""
    from repro_torch.analysis.registry import global_passes
    monkeypatch.setattr(K, "MIN_WORKSPACE", 64)
    p = global_passes()["launch-geometry"]
    snippets = {f.snippet for f in p.run(REPO, "cpu")}
    assert {"score_select workspace",
            "score_select_experts workspace"} <= snippets


class _Stub:
    """A library whose entries record their arguments (checked against
    ``build.SIGNATURES``) and return 0."""

    def __init__(self):
        self.calls = []
        for name, argtypes in build.SIGNATURES.items():
            setattr(self, name, self._entry(name, argtypes))

    def _entry(self, name, argtypes):
        def entry(*args):
            assert len(args) == len(argtypes)
            for a, t in zip(args, argtypes):
                t.from_param(a)
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    lib = _Stub()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda _d: ctypes.c_void_p(0))
    K.reset_launch_counts()
    yield lib
    K.reset_launch_counts()


@pytest.mark.parametrize("B,want", [(8, "cluster"), (32, "cluster"),
                                    (K.SCORE_SPREAD_MIN_ROWS, "spread"),
                                    (4099, "spread")])
def test_score_select_launch_passes_the_workspace_in_the_spread_form(
        stub, B, want):
    """The 2-D launch passes the device workspace and its length where
    the shape's form is the spread form (none at decode and chunk rows),
    the form argument -1 (the C entry's own choice), and counts one
    ``score_select`` and, in the spread form, one ``spread_launches``."""
    n, kb = 1024, 4
    x = torch.zeros(B, n, dtype=torch.bfloat16)
    g = torch.ones(n)
    TK_args = (x, g, torch.tensor(1.0), torch.tensor(0.5), torch.tensor(0.5),
               128, kb, torch.ones(B))
    K._launch_score(*TK_args)
    ((name, args),) = stub.calls
    assert name == "wisparse_score_select"
    assert args[9:14] == (B, n, 128, kb, 1)
    ws, _ = K.scratch_tensors("cpu")
    if want == "spread":
        assert args[14] == ws.data_ptr() and args[15] == ws.numel()
        assert args[15] >= K.MIN_WORKSPACE
    else:
        assert args[14] is None and args[15] == 0
    assert args[16] == -1
    assert K.launch_counts["score_select"] == 1
    assert K.spread_launches["score_select"] == int(want == "spread")


@pytest.mark.parametrize("E,R,n,want", [
    (16, 8, 4096, "expert"), (16, 8, 14336, "cluster"),
    (16, MIN_E - 1, 14336, "cluster"), (16, MIN_E, 4096, "spread"),
    (16, 641, 14336, "spread"), (48, 9, 512, "expert"),
    (48, MIN_E, 1536, "expert"), (48, 113, 1536, "spread"),
    (48, 448, 512, "spread")])
@pytest.mark.parametrize("form", [None, "cluster", "spread"])
def test_expert_launch_passes_the_workspace_in_the_spread_form(
        stub, E, R, n, want, form):
    """The expert launch passes the device workspace and its length only
    where the form is the spread form (the shape's own, or forced), the
    form argument (-1 the C entry's own choice, 0 / 1 forced), and counts
    one ``score_select_experts`` and, in the spread form, one
    ``spread_launches`` entry."""
    kb = 4
    x = torch.zeros(E, R, n, dtype=torch.bfloat16)
    g = torch.ones(E, n)
    K._launch_score(x, g, torch.tensor(1.0), torch.tensor(0.5),
                    torch.tensor(0.5), 128, kb, None, form)
    ((name, args),) = stub.calls
    assert name == "wisparse_score_select_experts"
    assert args[8:14] == (E, R, n, 128, kb, 1)
    spread = (form or want) == "spread"
    ws, _ = K.scratch_tensors("cpu")
    if spread:
        assert args[14] == ws.data_ptr() and args[15] == ws.numel()
        assert args[15] >= K.MIN_WORKSPACE
    else:
        assert args[14] is None and args[15] == 0
    assert args[16] == K.SCORE_FORM_CODES[form]
    assert K.launch_counts["score_select_experts"] == 1
    assert K.spread_launches == {"score_select": 0,
                                 "score_select_experts": int(spread)}


@pytest.mark.parametrize("B,m,dtype,want", [
    (4096, 4096, torch.bfloat16, "tile"), (4099, 14336, torch.bfloat16,
                                           "tile"),
    (4096, 16, torch.bfloat16, "tile"), (1024, 16, torch.bfloat16, "gather"),
    (4096, 4096, torch.float32, "gather"), (32, 4096, torch.bfloat16,
                                            "gather")])
def test_2d_matmul_launch_passes_the_routed_plan(stub, B, m, dtype, want):
    """The 2-D wrapper passes ``expert_plan``'s rows, columns and splits
    at one expert, and counts one ``sparse_matmul_shared`` and, in the
    tile form, one ``tile_launches`` entry."""
    n, kb = 1024, 4
    x = torch.zeros(B, n, dtype=dtype)
    w = torch.zeros(n, m, dtype=dtype)
    idx = torch.arange(kb, dtype=torch.int32)
    K._launch_matmul("sparse_matmul_shared", x, w, idx, 128, kb,
                     per_seq=False)
    ((name, args),) = stub.calls
    plan = K.expert_plan(B, n, m, kb, 128, x.element_size(), 1,
                         x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    assert plan.form == want
    assert name == "wisparse_sparse_matmul_shared"
    assert args[6:14] == (B, n, m, 128, kb, plan.rows, plan.cols,
                          plan.splits)
    assert K.launch_counts["sparse_matmul_shared"] == 1
    assert K.tile_launches["sparse_matmul_shared"] == int(want == "tile")


def _tie_free(x, g, alpha, tau):
    s = np.abs(x.astype(np.float64)) * np.maximum(g, 1e-12) ** alpha
    near = np.abs(s - tau) <= 1e-3 * max(abs(tau), 1e-3)
    x = x.copy()
    x[near] *= 1.05
    return x


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_wisparse_project_matches_pallas_at_whole_prefill_rows(dtype, tol):
    """At B = 257 rows, n = 512, m = 768 (3 x 3 output tiles), where the
    card takes the tile form and the spread form, ``wisparse_project`` on CPU tensors (the
    plain versions) equals the JAX ``pallas`` projection (interpret mode),
    with token weights; no kernel launch is counted."""
    B, n, m = 257, 512, 768
    assert K.expert_plan(B, n, m, 2, 128, 2, 1).form == "tile"
    assert K.score_form(B, n, 128) == "spread"
    rng = np.random.default_rng(32)
    x = rng.standard_normal((B, n)).astype(np.float32)
    w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
    g = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    tw = rng.random(B).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = torch.from_numpy(x).to(tdt).float().numpy()
    x = _tie_free(x, g, 0.7, 0.2)
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(0.7),
            "tau": jnp.float32(0.2), "keep_frac": jnp.float32(0.375)}
    sp_t = {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}
    yj = jops.wisparse_project(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                               sp_j, block=128, k_frac=0.5, interpret=True,
                               token_weights=jnp.asarray(tw))
    K.reset_launch_counts()
    yt = tops.wisparse_project(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(w).to(tdt), sp_t, block=128,
                               k_frac=0.5, token_weights=torch.from_numpy(tw))
    assert yt.shape == (B, m) and yt.dtype == tdt
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    assert not any(K.launch_counts.values())
    assert not any(K.tile_launches.values())
    assert not any(K.spread_launches.values())


def _jax_selection(x, g, sp, blk, kb):
    """The reference's selection (the Pallas ``score_mask`` in interpret
    mode, ``lax.top_k``, the rank mask) under ``jax.vmap`` over experts:
    (xm, idx)."""
    nb = x.shape[-1] // blk

    def one(xe, ge):
        xm, bs = JK.score_mask(xe, ge, sp["alpha"], sp["tau"], blk=blk,
                               interpret=True)
        _, idx = jax.lax.top_k(bs, kb)
        kb_l = jnp.round(sp["keep_frac"] * nb).astype(jnp.int32)
        keep = jnp.zeros((nb,), bool).at[idx].set(jnp.arange(kb) < kb_l)
        return xm * jnp.repeat(keep, blk)[None].astype(xm.dtype), idx
    return jax.vmap(one)(x, g)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_wisparse_project_experts_matches_pallas_at_spread_rows(dtype, tol):
    """At R = 65 rows per expert (3 experts, n = 512, m = 384), where the
    card takes the expert spread form and the tile form,
    ``wisparse_project_experts`` on CPU tensors (the plain versions)
    equals the JAX ``pallas`` projection under ``jax.vmap`` over experts
    (interpret mode), expert 1 all zero; the kept ids and xm equal the
    reference's; no kernel launch is counted."""
    E, R, n, m, blk, kb = 3, 65, 512, 384, 128, 2
    assert K.score_form(R, n, blk, 2, True, True) == "spread"
    assert K.expert_plan(R, n, m, kb, blk, 2, E).form == "tile"
    rng = np.random.default_rng(34)
    x = rng.standard_normal((E, R, n)).astype(np.float32)
    x[1] = 0                                  # an expert no token chose
    w = (rng.standard_normal((E, n, m)) * 0.1).astype(np.float32)
    g = (np.abs(rng.standard_normal((E, n))) + 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = torch.from_numpy(x).to(tdt).float().numpy()
    x = _tie_free(x, g[:, None], 0.7, 0.2)
    sp_j = {"alpha": jnp.float32(0.7), "tau": jnp.float32(0.2),
            "keep_frac": jnp.float32(0.375)}
    sp_t = {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    yj = jax.vmap(lambda xe, we, ge: jops.wisparse_project(
        xe, we, {**sp_j, "g": ge}, block=blk, k_frac=0.5, interpret=True))(
        xj, wj, jnp.asarray(g))
    K.reset_launch_counts()
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    yt = tops.wisparse_project_experts(xt, wt, {**sp_t,
                                                "g": torch.from_numpy(g)},
                                       block=blk, k_frac=0.5)
    assert yt.shape == (E, R, m) and yt.dtype == tdt
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    xm, idx, _ = K.score_select_experts(xt, torch.from_numpy(g),
                                        sp_t["alpha"], sp_t["tau"],
                                        sp_t["keep_frac"], kb=kb, blk=blk)
    jxm, jidx = _jax_selection(xj, jnp.asarray(g), sp_j, blk, kb)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[1].tolist() == list(range(kb))
    assert np.array_equal(xm.float().numpy(),
                          np.asarray(jxm.astype(jnp.float32)))
    assert not any(K.launch_counts.values())
    assert not any(K.spread_launches.values())
