"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX kernels in interpret mode (as
``tests/test_kernels.py`` runs them) and through the port's wrappers on
CPU tensors, which take the kernels' plain PyTorch versions.  The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold them against these plain versions.

Tolerances: f32 1e-5 and bf16 3e-2, as ``tests/test_kernels.py`` uses
for the same kernels; block scores rtol 1e-4 (f32 sums in another
order).  Score-mask inputs are tie-free: no score lies within 0.1% of
tau, so the keep decision cannot hinge on the last bit of a pow.  Block
scores that tie exactly are built on purpose where the tie order is the
point: the port follows ``jax.lax.top_k`` (the lower id first)."""
import ctypes
import dataclasses
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_linear as jsl
from repro.kernels import ops as jops
from repro.kernels import sparse_matmul as JK
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.core import sparse_linear as tsl
from repro_torch.kernels import build, ref, select
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_matmul as TK
from repro_torch.sparsity import SparsityPolicy

SHAPES = [
    (1, 256, 128, 128),
    (4, 512, 384, 128),
    (8, 1024, 512, 256),
    (3, 384, 256, 128),
]
AWKWARD = [
    (5, 256, 257, 128),
    (13, 384, 131, 128),
    (9, 512, 384, 256),
    (1, 128, 1, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _data(B, n, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n)).astype(np.float32)
    w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
    g = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    return x, w, g


def _tie_free(x, g, alpha, tau):
    s = np.abs(x.astype(np.float64)) * np.maximum(g, 1e-12) ** alpha
    near = np.abs(s - tau) <= 1e-3 * max(abs(tau), 1e-3)
    x = x.copy()
    x[near] *= 1.05
    return x


def _both(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("B,n,m,blk", SHAPES + AWKWARD)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sparse_matmul_shared_matches_pallas(B, n, m, blk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w, _ = _data(B, n, m)
    jx, tx = _both(x, jdt, tdt)
    jw, tw = _both(w, jdt, tdt)
    idx = np.arange(0, n // blk, 2, dtype=np.int32)
    yj = JK.sparse_matmul_shared(jx, jw, jnp.asarray(idx), blk=blk,
                                 interpret=True)
    yt = TK.sparse_matmul_shared(tx, tw, torch.from_numpy(idx), blk=blk)
    assert yt.shape == (B, m) and yt.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=tol, atol=tol)


def test_sparse_matmul_shared_duplicate_ids_count_twice():
    """The pad contract: a repeated block id contributes once per entry."""
    x, w, _ = _data(2, 256, 64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    once = TK.sparse_matmul_shared(tx, tw, torch.tensor([1], dtype=torch.int32))
    twice = TK.sparse_matmul_shared(tx, tw,
                                    torch.tensor([1, 1], dtype=torch.int32))
    yj = JK.sparse_matmul_shared(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray([1, 1], jnp.int32),
                                 interpret=True)
    np.testing.assert_allclose(twice.numpy(), 2 * once.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(twice.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


def _per_seq_ids(B, n, blk):
    """tests/test_kernels.py's per-seq ids: row b keeps the blocks
    (arange(kb) + b) % nb, kb = max(nb // 2, 1)."""
    nb = n // blk
    kb = max(nb // 2, 1)
    return np.stack([(np.arange(kb) + b) % nb for b in range(B)]
                    ).astype(np.int32)


@pytest.mark.parametrize("B,n,m,blk", SHAPES + AWKWARD)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sparse_matmul_per_seq_matches_pallas(B, n, m, blk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w, _ = _data(B, n, m)
    jx, tx = _both(x, jdt, tdt)
    jw, tw = _both(w, jdt, tdt)
    idx = _per_seq_ids(B, n, blk)
    yj = JK.sparse_matmul_per_seq(jx, jw, jnp.asarray(idx), blk=blk,
                                  interpret=True)
    yt = TK.sparse_matmul_per_seq(tx, tw, torch.from_numpy(idx), blk=blk)
    assert yt.shape == (B, m) and yt.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=tol, atol=tol)


def test_sparse_matmul_per_seq_duplicate_ids_count_twice():
    x, w, _ = _data(2, 256, 64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ids = np.array([[1, 1], [0, 1]], np.int32)
    twice = TK.sparse_matmul_per_seq(tx, tw, torch.from_numpy(ids))
    once = TK.sparse_matmul_shared(tx[:1], tw,
                                   torch.tensor([1], dtype=torch.int32))
    yj = JK.sparse_matmul_per_seq(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(ids), interpret=True)
    np.testing.assert_allclose(twice[0].numpy(), 2 * once[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(twice.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,n,m,blk", SHAPES[:3] + AWKWARD[:3])
def test_wisparse_project_per_seq(B, n, m, blk):
    """per_seq=True gives every row the shared ids (the reference's only
    use of the per-seq kernel): equal to JAX's and to per_seq=False."""
    x, w, g = _data(B, n, m)
    x = _tie_free(x, g, 0.7, 0.2)
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(0.7),
            "tau": jnp.float32(0.2), "keep_frac": jnp.float32(0.5)}
    sp_t = {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}
    yj = jops.wisparse_project(jnp.asarray(x), jnp.asarray(w), sp_j,
                               block=blk, k_frac=0.75, interpret=True,
                               per_seq=True)
    TK.reset_launch_counts()
    yt = tops.wisparse_project(torch.from_numpy(x), torch.from_numpy(w), sp_t,
                               block=blk, k_frac=0.75, per_seq=True)
    ys = tops.wisparse_project(torch.from_numpy(x), torch.from_numpy(w), sp_t,
                               block=blk, k_frac=0.75)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(yt.numpy(), ys.numpy(), rtol=1e-5, atol=1e-5)
    assert set(TK.launch_counts.values()) == {0}


@pytest.mark.parametrize("B,n,m,blk", SHAPES + AWKWARD)
@pytest.mark.parametrize("alpha,tau", [(0.0, 0.3), (0.7, 0.5), (1.5, 1.0)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_score_mask_matches_pallas(B, n, m, blk, alpha, tau, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x, _, g = _data(B, n, m)
    x = _tie_free(torch.from_numpy(x).to(tdt).float().numpy(), g, alpha, tau)
    jx, tx = _both(x, jdt, tdt)
    rw = np.random.default_rng(1).random(B).astype(np.float32)
    xm_j, bs_j = JK.score_mask(jx, jnp.asarray(g), alpha, tau, blk=blk,
                               interpret=True, row_weights=jnp.asarray(rw))
    xm_t, bs_t = TK.score_mask(tx, torch.from_numpy(g), alpha, tau, blk=blk,
                               row_weights=torch.from_numpy(rw))
    assert xm_t.dtype == tdt and bs_t.dtype == torch.float32
    np.testing.assert_array_equal(_np(xm_t), _np(xm_j))
    np.testing.assert_allclose(bs_t.numpy(), np.asarray(bs_j), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("B,n,m,blk", SHAPES + AWKWARD[:3])
@pytest.mark.parametrize("k_frac,keep_frac", [(1.0, 1.0), (0.75, 0.5),
                                              (0.5, 0.5)])
def test_wisparse_project_matches_pallas(B, n, m, blk, k_frac, keep_frac):
    x, w, g = _data(B, n, m)
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(0.7),
            "tau": jnp.float32(0.2), "keep_frac": jnp.float32(keep_frac)}
    sp_t = {"g": torch.from_numpy(g), "alpha": torch.tensor(0.7),
            "tau": torch.tensor(0.2), "keep_frac": torch.tensor(keep_frac)}
    x = _tie_free(x, g, 0.7, 0.2)
    yj = jops.wisparse_project(jnp.asarray(x), jnp.asarray(w), sp_j,
                               block=blk, k_frac=k_frac, interpret=True)
    yt = tops.wisparse_project(torch.from_numpy(x), torch.from_numpy(w), sp_t,
                               block=blk, k_frac=k_frac)
    assert yt.shape == (B, m)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,n,m,blk", [(4, 257, 128, 128),
                                       (3, 384 + 7, 131, 128)])
def test_wisparse_project_awkward_channel_dim(B, n, m, blk):
    """Non-divisible channel dims pad to full-width blocks in both."""
    x, w, g = _data(B, n, m)
    x = _tie_free(x, g, 0.7, 0.2)
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(0.7),
            "tau": jnp.float32(0.2), "keep_frac": jnp.float32(0.5)}
    sp_t = {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}
    tw = np.random.default_rng(2).random(B).astype(np.float32)
    yj = jops.wisparse_project(jnp.asarray(x), jnp.asarray(w), sp_j,
                               block=blk, k_frac=0.75, interpret=True,
                               token_weights=jnp.asarray(tw))
    yt = tops.wisparse_project(torch.from_numpy(x), torch.from_numpy(w), sp_t,
                               block=blk, k_frac=0.75,
                               token_weights=torch.from_numpy(tw))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tau", [float("-inf"), float("inf")])
def test_wisparse_project_tau_extremes(tau):
    """tau=-inf keeps every channel, so full keep is the dense product;
    tau=+inf (the reference's uncalibrated sp tree) masks everything and
    the projection is exactly zero — in the reference and the port."""
    x, w, g = _data(4, 512, 256)
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(1.0),
            "tau": jnp.float32(tau), "keep_frac": jnp.float32(1.0)}
    sp_t = {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}
    yj = np.asarray(jops.wisparse_project(jnp.asarray(x), jnp.asarray(w),
                                          sp_j, interpret=True))
    yt = tops.wisparse_project(torch.from_numpy(x), torch.from_numpy(w), sp_t)
    want = x @ w if tau < 0 else np.zeros((4, 256), np.float32)
    np.testing.assert_allclose(yt.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)


def test_plain_versions_match_the_reference_oracle():
    """ref_wisparse_project mirrors repro.kernels.ref.ref_wisparse_project."""
    from repro.kernels import ref as jref
    x, w, g = _data(4, 512, 384)
    x = _tie_free(x, g, 0.7, 0.2)
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(0.7),
            "tau": jnp.float32(0.2), "keep_frac": jnp.float32(0.5)}
    sp_t = {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}
    yj = jref.ref_wisparse_project(jnp.asarray(x), jnp.asarray(w), sp_j,
                                   k_blocks=3, blk=128)
    yt = ref.ref_wisparse_project(torch.from_numpy(x), torch.from_numpy(w),
                                  sp_t, k_blocks=3, blk=128)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors never touch the kernel library: the wrappers return the
    plain versions' results and count no launch."""
    def no_library():
        raise AssertionError("the CPU route must not load the kernels")
    monkeypatch.setattr(build, "library", no_library)
    TK.reset_launch_counts()
    x, w, g = _data(3, 256, 64)
    tx, tw, tg = map(torch.from_numpy, (x, w, g))
    xm, bs = TK.score_mask(tx, tg, 0.5, 0.2, blk=128)
    xm_r, bs_r = ref.ref_score_mask(tx, tg, 0.5, 0.2, 128)
    assert torch.equal(xm, xm_r) and torch.equal(bs, bs_r)
    got = TK.score_select(tx, tg, 0.5, 0.2, 0.5, kb=2, blk=128)
    want = ref.ref_score_select(tx, tg, 0.5, 0.2, 0.5, 128, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    idx = torch.tensor([1, 0], dtype=torch.int32)
    assert torch.equal(TK.sparse_matmul_shared(tx, tw, idx),
                       ref.ref_sparse_matmul_shared(tx, tw, idx, 128))
    ids = torch.tensor([[1, 0], [0, 0], [1, 1]], dtype=torch.int32)
    assert torch.equal(TK.sparse_matmul_per_seq(tx, tw, ids),
                       ref.ref_sparse_matmul_per_seq(tx, tw, ids, 128))
    assert TK.launch_counts == {"score_select": 0, "sparse_matmul_shared": 0,
                                "sparse_matmul_per_seq": 0}


def test_non_cpu_tensors_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses what it cannot launch — it never silently takes the plain
    version."""
    x = torch.empty(2, 256, device="meta")
    g = torch.empty(256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TK.score_mask(x, g, 0.0, 0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        TK.score_select(x, g, 0.0, 0.0, 1.0, kb=1)
    w = torch.empty(256, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TK.sparse_matmul_shared(x, w, torch.zeros(1, dtype=torch.int32,
                                                  device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        TK.sparse_matmul_per_seq(x, w, torch.zeros(2, 1, dtype=torch.int32,
                                                   device="meta"))


def test_wrappers_validate_shapes():
    x = torch.zeros(2, 200)
    with pytest.raises(ValueError, match="multiple of blk"):
        TK.score_mask(x, torch.ones(200), 0.0, 0.0, blk=128)
    with pytest.raises(ValueError, match="multiple of blk"):
        TK.score_select(x, torch.ones(200), 0.0, 0.0, 1.0, kb=1, blk=128)
    with pytest.raises(ValueError, match="kb 3 outside"):
        TK.score_select(torch.zeros(2, 256), torch.ones(256), 0.0, 0.0, 1.0,
                        kb=3, blk=128)
    with pytest.raises(ValueError, match="w rows"):
        TK.sparse_matmul_shared(torch.zeros(2, 256), torch.zeros(128, 4),
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="block_idx must be"):
        TK.sparse_matmul_per_seq(torch.zeros(2, 256), torch.zeros(256, 4),
                                 torch.zeros(3, 1, dtype=torch.int32))


def test_kernel_modules_import_without_nvcc_or_card(tmp_path, monkeypatch):
    """Importing the kernel modules builds nothing (a fresh interpreter
    imports every module and the build cache stays empty), and a build
    without nvcc raises a clear error instead of falling back."""
    code = ("import repro_torch.kernels.ops, repro_torch.kernels.build as b, "
            "repro_torch.serving, repro_torch.launch.serve; "
            "assert b.library.cache_info().currsize == 0; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PATH": "/usr/bin:/bin",
                                         "PYTHONPATH": ":".join(sys.path),
                                         "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


# llama31_8b's projection shapes (n, m) and the kept-block counts the
# main path gives them at 50%
MAIN_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("n,m", MAIN_SHAPES + [(1024, 384), (128, 1)])
@pytest.mark.parametrize("B", [1, 8, 13, 32, 33])
@pytest.mark.parametrize("per_seq", [False, True])
def test_launch_plan_slices_cover_every_unit_once(n, m, B, per_seq):
    """Across its S slices the plan walks every position of idx (shared)
    or every block id (per-seq) exactly once, for kb = 1..nb; per-seq
    slices span at most MAX_SLICE_BLOCKS ids, and no slice of the shared
    kernel is empty."""
    nb = n // 128
    for kb in range(1, nb + 1):
        plan = TK.launch_plan(B, n, m, kb, 128, per_seq)
        units = nb if per_seq else kb
        assert plan.units == units and 1 <= plan.splits <= units
        walked = [u for s in range(plan.splits) for u in plan.slice(s)]
        assert walked == list(range(units))
        sizes = [len(plan.slice(s)) for s in range(plan.splits)]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
        if per_seq:
            assert max(sizes) <= TK.MAX_SLICE_BLOCKS


@pytest.mark.parametrize("B,n,m,kb", [
    (1, 128, 1, 1), (8, 4096, 1024, 16), (32, 14336, 4096, 56),
    (4096, 4096, 14336, 32), (200_000, 8192, 128, 64),
    (8, 131072, 256, 1024), (2, 262144, 64, 2048)])
@pytest.mark.parametrize("per_seq", [False, True])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_launch_plan_grid_within_launch_limits(B, n, m, kb, per_seq,
                                               elem_bytes):
    plan = TK.launch_plan(B, n, m, kb, 128, per_seq, elem_bytes)
    gx, gy, gz = plan.grid
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    assert gx * TK.TILE_COLS[elem_bytes] >= m > (gx - 1) * TK.TILE_COLS[
        elem_bytes]
    assert plan.rows in (8, 16, 32) and gz * plan.rows >= B
    assert gz == 1 or B > 32
    if per_seq:
        assert -(-(n // 128) // plan.splits) <= TK.MAX_SLICE_BLOCKS


@pytest.mark.parametrize("B,n,m,kb,per_seq", [
    (8, 4096, 1024, 16, False), (32, 14336, 4096, 56, True),
    (8, 4096, 14336, 16, False), (1, 128, 1, 1, False),
    (33, 1024, 4096, 5, True)])
def test_matmul_scratch_matches_the_plan(monkeypatch, B, n, m, kb, per_seq):
    """The device's scratch holds what the plan needs, is reused by the
    next launch, and grows only for a plan that needs more."""
    monkeypatch.setattr(TK, "_scratch", {})
    plan = TK.launch_plan(B, n, m, kb, 128, per_seq)
    ws, cnt = TK.matmul_scratch(plan, "cpu")
    if plan.splits == 1:
        assert ws is None and cnt is None and plan.workspace == 0
        return
    assert plan.workspace == plan.splits * B * m
    assert ws.dtype == torch.float32 and ws.numel() >= plan.workspace
    assert plan.counters == plan.tiles_m * plan.tiles_b
    assert cnt.dtype == torch.int32 and cnt.numel() >= plan.counters
    assert not cnt.any()
    ws2, cnt2 = TK.matmul_scratch(plan, "cpu")
    assert ws2 is ws and cnt2 is cnt
    big = dataclasses.replace(plan, workspace=ws.numel() + 1,
                              counters=cnt.numel() + 1)
    ws3, cnt3 = TK.matmul_scratch(big, "cpu")
    assert ws3.numel() >= big.workspace and cnt3.numel() >= big.counters
    assert not cnt3.any()
    assert TK.matmul_scratch(plan, "cpu") == (ws3, cnt3)


def test_plan_geometry_matches_the_kernel_header():
    """The plan's column tiles and per-seq slice limit are the ones
    csrc/gather_mma.cuh compiles (its C entries refuse others)."""
    src = (build.CSRC / "gather_mma.cuh").read_text()
    cols = dict(re.findall(
        r"struct Geom<(\w+)> \{\s*static constexpr int kCols = (\d+);",
        src))
    assert {2: int(cols["__nv_bfloat16"]), 4: int(cols["float"])} == \
        TK.TILE_COLS
    (max_slice,) = re.findall(r"constexpr int kMaxSlice = (\d+);", src)
    assert int(max_slice) == TK.MAX_SLICE_BLOCKS


@pytest.mark.parametrize("name,per_seq", [("sparse_matmul_shared", False),
                                          ("sparse_matmul_per_seq", True)])
@pytest.mark.parametrize("B,n,m,kb", [(8, 4096, 1024, 16), (1, 256, 64, 1)])
def test_matmul_launch_passes_the_c_signature(monkeypatch, name, per_seq, B,
                                              n, m, kb):
    """The arguments the wrapper passes fit ``build.SIGNATURES`` (a stub
    library stands in for the compiled one: no nvcc needed)."""
    calls = []

    def entry(*args):
        argtypes = build.SIGNATURES["wisparse_" + name]
        assert len(args) == len(argtypes)
        for a, t in zip(args, argtypes):
            t.from_param(a)
        calls.append(args)
        return 0

    class Stub:
        pass

    stub = Stub()
    setattr(stub, "wisparse_" + name, entry)
    monkeypatch.setattr(build, "library", lambda: stub)
    monkeypatch.setattr(TK, "_stream", lambda _d: ctypes.c_void_p(0))
    x = torch.zeros(B, n, dtype=torch.bfloat16)
    w = torch.zeros(n, m, dtype=torch.bfloat16)
    idx = torch.zeros((B, kb) if per_seq else (kb,), dtype=torch.int32)
    TK.reset_launch_counts()
    y = TK._launch_matmul(name, x, w, idx, 128, kb, per_seq=per_seq)
    assert y.shape == (B, m) and y.dtype == torch.float32
    assert TK.launch_counts[name] == 1
    TK.reset_launch_counts()
    (args,) = calls
    plan = TK.launch_plan(B, n, m, kb, 128, per_seq)
    assert args[6:15] == (B, n, m, 128, kb, plan.rows, plan.cols,
                          plan.splits, 1)
    assert (args[4] is None) == (args[5] is None) == (plan.splits == 1)


# ---------------------------------------------------------------------------
# score_select: the selection folded into the scoring kernel
# ---------------------------------------------------------------------------

def _jax_score_select(x, g, alpha, tau, keep_frac, blk, kb, rw):
    """The reference's chain in ``repro.kernels.ops.wisparse_project``:
    the Pallas ``score_mask`` (interpret mode), ``lax.top_k``, the rank
    mask."""
    xm, bs = JK.score_mask(x, g, alpha, tau, blk=blk, interpret=True,
                           row_weights=rw)
    _, idx = jax.lax.top_k(bs, kb)
    nb = x.shape[1] // blk
    kb_l = jnp.round(jnp.float32(keep_frac) * nb).astype(jnp.int32)
    keep_blocks = jnp.zeros((nb,), bool).at[idx].set(jnp.arange(kb) < kb_l)
    xm = xm * jnp.repeat(keep_blocks, blk)[None].astype(xm.dtype)
    return xm, idx, bs


@pytest.mark.parametrize("B,n,m,blk", SHAPES + AWKWARD[:3])
@pytest.mark.parametrize("keep_frac", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_score_select_matches_the_reference_chain(B, n, m, blk, keep_frac,
                                                  dtype):
    """ref_score_select (the CPU route of score_select) against the JAX
    chain at k_frac 0.5, with keep_frac below, equal to and above it:
    xm and idx equal, bs to 1e-5 (f32 sums in another order)."""
    jdt, tdt, _ = DTYPES[dtype]
    alpha, tau = 0.7, 0.2
    x, _, g = _data(B, n, m, seed=3)
    x = _tie_free(torch.from_numpy(x).to(tdt).float().numpy(), g, alpha, tau)
    jx, tx = _both(x, jdt, tdt)
    rw = np.random.default_rng(4).random(B).astype(np.float32)
    nb = n // blk
    kb = max(1, round(nb * 0.5))
    xm_j, idx_j, bs_j = _jax_score_select(jx, jnp.asarray(g), alpha, tau,
                                          keep_frac, blk, kb,
                                          jnp.asarray(rw))
    xm_t, idx_t, bs_t = TK.score_select(
        tx, torch.from_numpy(g), torch.tensor(alpha), torch.tensor(tau),
        torch.tensor(keep_frac), kb=kb, blk=blk,
        row_weights=torch.from_numpy(rw))
    assert xm_t.dtype == tdt and idx_t.dtype == torch.int32
    assert idx_t.shape == (kb,) and bs_t.shape == (nb,)
    np.testing.assert_allclose(bs_t.numpy(), np.asarray(bs_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(_np(xm_t), _np(xm_j))


def _tied(B=2, blk=16, m=32, seed=0):
    """Inputs whose 112 channel blocks repeat one pattern, scaled by 2
    (10 blocks), 1 (60) or 0 (42) in a random order, with g = 1: every
    score is a small multiple of 1/4, so block scores and saliencies tie
    exactly within each group, and a budget of half the blocks (or
    channels) cuts through the group of 1s."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(-8, 9, (B, blk)).astype(np.float32) / 4
    mult = rng.permutation(np.repeat(np.float32([2, 1, 0]), [10, 60, 42]))
    x = (pat[:, None, :] * mult[None, :, None]).reshape(B, 112 * blk)
    w = (rng.standard_normal((112 * blk, m)) * 0.1).astype(np.float32)
    return x, w, np.ones(112 * blk, np.float32)


def _tied_sp(g, keep_frac, tau):
    sp_j = {"g": jnp.asarray(g), "alpha": jnp.float32(1.0),
            "tau": jnp.float32(tau), "keep_frac": jnp.float32(keep_frac)}
    return sp_j, {k: torch.tensor(np.asarray(v)) for k, v in sp_j.items()}


def test_topk_ids_takes_lax_top_k_order():
    scores = np.float32([1, 3, 1, 3, 0, 1, 3, 0])
    for k in range(1, 9):
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        got = select.topk_ids(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("keep_frac", [0.5, 0.375])
def test_pallas_projection_under_tied_block_scores(keep_frac):
    """Tied block scores with kb (56 of 112) and the layer's limit inside
    the tie: the port keeps the blocks lax.top_k keeps (the lower ids
    first), so the projection equals the reference's."""
    x, w, g = _tied()
    sp_j, sp_t = _tied_sp(g, keep_frac, float("-inf"))
    yj = jops.wisparse_project(jnp.asarray(x), jnp.asarray(w), sp_j,
                               block=16, k_frac=0.5, interpret=True)
    yt = tops.wisparse_project(torch.from_numpy(x), torch.from_numpy(w), sp_t,
                               block=16, k_frac=0.5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["topk_block", "topk_shared"])
@pytest.mark.parametrize("keep_frac", [0.5, 0.375])
def test_gather_projections_under_tied_scores(backend, keep_frac):
    """The gather backends under tied saliencies (blocks for topk_block,
    channels for topk_shared) equal the reference's sparse_linear.project."""
    x, w, g = _tied(seed=1)
    sp_j, sp_t = _tied_sp(g, keep_frac, float("inf"))
    kw = dict(k_max_frac=0.5, block=16)
    yj = jsl.project(jnp.asarray(x), jnp.asarray(w), sp_j,
                     policy=JPolicy.uniform(backend, interpret=True, **kw))
    yt = tsl.project(torch.from_numpy(x), torch.from_numpy(w), sp_t,
                     policy=SparsityPolicy.uniform(backend, **kw))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("select", [True, False])
@pytest.mark.parametrize("B,n,kb,dtype", [
    (8, 4096, 16, torch.bfloat16), (32, 14336, 56, torch.bfloat16),
    (1, 256, 1, torch.float32)])
def test_score_select_launch_passes_the_c_signature(monkeypatch, select, B, n,
                                                    kb, dtype):
    """The arguments the wrapper passes fit ``build.SIGNATURES`` (a stub
    library stands in for the compiled one: no nvcc needed); the sp
    tree's f32 scalars and f32 row weights reach the kernel as they are,
    uncopied; the mask alone passes no keep_frac and no idx."""
    calls = []

    def entry(*args):
        argtypes = build.SIGNATURES["wisparse_score_select"]
        assert len(args) == len(argtypes)
        for a, t in zip(args, argtypes):
            t.from_param(a)
        calls.append(args)
        return 0

    class Stub:
        wisparse_score_select = staticmethod(entry)

    monkeypatch.setattr(build, "library", lambda: Stub())
    monkeypatch.setattr(TK, "_stream", lambda _d: ctypes.c_void_p(0))
    x = torch.zeros(B, n, dtype=dtype)
    g = torch.ones(n)
    alpha, tau, keep = torch.tensor(1.0), torch.tensor(0.5), torch.tensor(0.5)
    rw = torch.ones(B)
    TK.reset_launch_counts()
    xm, idx, bs = TK._launch_score(x, g, alpha, tau, keep if select else None,
                                   128, kb if select else n // 128, rw)
    assert TK.launch_counts["score_select"] == 1
    TK.reset_launch_counts()
    assert xm.shape == x.shape and xm.dtype == dtype
    assert bs.shape == (n // 128,) and bs.dtype == torch.float32
    (args,) = calls
    assert args[2:4] == (alpha.data_ptr(), tau.data_ptr())
    assert args[5] == rw.data_ptr()
    if select:
        assert idx.shape == (kb,) and idx.dtype == torch.int32
        assert args[4] == keep.data_ptr() and args[7] == idx.data_ptr()
    else:
        assert idx is None and args[4] is None and args[7] is None
    assert args[9:14] == (B, n, 128, kb if select else n // 128,
                          1 if dtype == torch.bfloat16 else 0)
