"""repro_torch.analysis's global passes on the CPU: clean on the tree,
and each catches its seeded fault — a decode step or a pool op that
copies a cache leaf out of place (``graph-in-place``), an identity-hashed
policy and a capture outside ``GraphSpace.capture`` (``graph-keys``), a
plan whose slices skip a unit, a shared-memory mirror over 232,448 B and
a cluster of 32 (``launch-geometry``), as ``tests/test_analysis.py``
does for the JAX passes.  The mirror's constants are read back from the
CUDA sources, and the query's Python side is checked against the C
signature with a stub library (no nvcc here)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.analysis import run_global_passes
from repro_torch.analysis.registry import global_passes
from repro_torch.kernels import build
from repro_torch.kernels import geometry as G
from repro_torch.kernels import sparse_matmul as K
from torch_threads import one_thread_module  # noqa: F401 (autouse)

HERE = os.path.dirname(__file__)
REPO = os.path.abspath(os.path.join(HERE, os.pardir))
CORPUS = os.path.join(HERE, "torch_analysis_corpus")


def test_global_passes_clean_on_tree():
    """Acceptance: the pool written in place, the keys stable, every
    launch inside the card's limits — zero findings over the 3-rung
    warmup set and the ten archs' shapes."""
    assert run_global_passes(REPO, device="cpu") == []
    rep = global_passes()["launch-geometry"].report
    assert rep["shapes"] > 150 and rep["compared"] == 0
    assert all(0 < v <= G.H100_LIMITS["smem_optin"]
               for v in rep["smem"].values())
    # the expert selection's sweep exercises its three forms, and the 2-D
    # entry's two: the cluster (and per expert) at decode and chunk rows,
    # the spread form at whole-prefill rows
    assert rep["forms"] == {"score_select": ["cluster", "spread"],
                            "score_select_experts": ["cluster", "expert",
                                                     "spread"]}


# ---------------------------------------------------------------------------
# graph-in-place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["rebind", "copy"])
def test_graph_in_place_catches_an_out_of_place_decode(monkeypatch, fault):
    """A decode step that rebuilds a cache leaf out of place: rebinding it
    in the pool tree moves the leaf; copying a fresh whole leaf back in
    keeps the address but is a whole-leaf copy per step."""
    from repro_torch.models import api

    make = api.make_slot_decode_step

    def leaky(cfg):
        step = make(cfg)

        def run(params, tokens, positions, caches, sp, active, *, policy):
            out = step(params, tokens, positions, caches, sp, active,
                       policy=policy)
            entry = caches[0][0]["self"]
            if fault == "rebind":
                entry["k"] = entry["k"].clone()
            else:
                entry["v"].copy_(entry["v"] * 1.0)
            return out
        return run

    monkeypatch.setattr(api, "make_slot_decode_step", leaky)
    findings = global_passes()["graph-in-place"].run(REPO, "cpu")
    flagged = {f.snippet for f in findings}
    assert any(s.startswith("decode[rung=0]") for s in flagged), flagged
    assert all(f.path.endswith("serving/graphs.py") for f in findings)
    want = "moved" if fault == "rebind" else "copies"
    assert any(s.endswith(want) for s in flagged), flagged
    assert not any(s.startswith("chunk") for s in flagged), flagged


def test_graph_in_place_catches_an_out_of_place_rollback(monkeypatch):
    from repro_torch.serving import kv_pool

    def rollback_many(self, per_slot):
        for g in self.caches:
            for entry in g:
                k = entry["self"]["k"]
                k.copy_(torch.where(torch.ones_like(k, dtype=torch.bool), k,
                                    0))

    monkeypatch.setattr(kv_pool.SlotKVPool, "rollback_many", rollback_many)
    findings = global_passes()["graph-in-place"].run(REPO, "cpu")
    assert {f.snippet for f in findings} == {"rollback_many copies"}
    (f,) = findings
    assert f.path.endswith("serving/kv_pool.py")
    with open(os.path.join(REPO, f.path)) as fh:
        assert "def rollback_many(" in fh.read().splitlines()[f.line - 1]


# ---------------------------------------------------------------------------
# graph-keys
# ---------------------------------------------------------------------------

def test_graph_keys_catches_identity_hashed_policies(monkeypatch):
    """SparsityPolicy with object identity for hash and eq: a deep copy
    is another key, so serving under copied ladder policies looks up
    steps that were never built."""
    from repro_torch.sparsity import SparsityPolicy

    monkeypatch.setattr(SparsityPolicy, "__hash__", object.__hash__)
    monkeypatch.setattr(SparsityPolicy, "__eq__", object.__eq__)
    findings = global_passes()["graph-keys"].run(REPO, "cpu")
    msgs = " ".join(f.message for f in findings)
    assert "identity-based" in msgs
    assert "never built" in msgs or "not the built step" in msgs


def test_graph_keys_checks_each_key():
    p = global_passes()["graph-keys"]
    site = ("src/repro_torch/serving/graphs.py", 1)

    class IdentityHashed:
        pass

    class Unhashable:
        __hash__ = None

    assert any("identity" in f.message or "frozen" in f.message
               for f in p.check_key(IdentityHashed(), site))
    assert any("unhashable" in f.message
               for f in p.check_key((0, Unhashable()), site))
    assert any("frozen" in f.message for f in p.check_key([0, 1], site))
    assert p.check_key((2, "dense", None), site) == []


def test_graph_keys_catches_captures_outside_the_space():
    from test_torch_analysis import expected_findings
    want = expected_findings(CORPUS, {"graph-keys"})
    assert len(want) == 4
    got = {(f.path, f.line, f.rule)
           for f in global_passes()["graph-keys"].capture_sites(CORPUS)}
    assert got == want


def test_graph_keys_finds_the_tree_s_capture_sites(tmp_path):
    """The tree's captures all lie in GraphSpace.capture; a tree without
    any capture site is itself a finding (the pass lost track)."""
    p = global_passes()["graph-keys"]
    assert p.capture_sites(REPO) == []
    (tmp_path / "src").mkdir()
    (f,) = p.capture_sites(str(tmp_path))
    assert "no CUDA-graph capture site" in f.message


# ---------------------------------------------------------------------------
# launch-geometry
# ---------------------------------------------------------------------------

def _run_geometry():
    p = global_passes()["launch-geometry"]
    return p, p.run(REPO, "cpu")


def test_launch_geometry_catches_a_slice_that_skips_a_unit(monkeypatch):
    def skipping(self, s):
        r = range(s * self.units // self.splits,
                  (s + 1) * self.units // self.splits)
        return r[1:] if s == 0 and len(r) > 1 else r

    monkeypatch.setattr(K.LaunchPlan, "slice", skipping)
    _, findings = _run_geometry()
    assert any("do not partition" in f.message for f in findings)


def test_launch_geometry_catches_shared_memory_over_the_limit(monkeypatch):
    monkeypatch.setattr(G, "matmul_smem", lambda *_a: 232449)
    _, findings = _run_geometry()
    assert {f.snippet for f in findings} >= {
        "sparse_matmul_shared smem", "sparse_matmul_per_seq smem",
        "sparse_matmul_shared_experts smem"}
    assert all("232448" in f.message for f in findings
               if f.snippet.endswith("smem"))


def test_launch_geometry_catches_a_cluster_of_32(monkeypatch):
    monkeypatch.setattr(G, "SCORE_CLUSTER", 32)
    _, findings = _run_geometry()
    assert "score_select cluster" in {f.snippet for f in findings}
    assert any(re.search(r"a cluster of (1[7-9]|2\d|3[0-2]) blocks exceeds 16",
                         f.message) for f in findings)


def test_launch_geometry_covers_nine_archs_at_published_width():
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.graphs import matmul_shapes

    p = global_passes()["launch-geometry"]
    shapes = set(p.shapes())
    archs = ("llama31_8b", "gemma2_2b", "gemma3_4b", "granite_moe_1b_a400m",
             "granite_moe_3b_a800m", "mamba2_130m", "whisper_large_v3",
             "internvl2_26b", "deepseek_67b", "jamba_v01_52b")
    for arch in archs:
        abstract, _, _ = api.abstract_model(get_config(arch))
        mine = set(matmul_shapes(abstract, {128}, {1, 8, 32, 448}))
        dense = {s for s in mine if s[5] == 1}
        assert dense and dense <= shapes, arch
    assert {s[0] for s in shapes} >= {1, 8, 32, 448}
    assert any(s[5] == 48 for s in shapes)          # granite's experts
    assert any(s[5] == 32 for s in shapes)          # granite 1b's
    assert (8, 14336, 4096, 128, 2, 1) in shapes    # llama31_8b mlp/wo


# The form of score_select_experts at every MoE arch's expert shapes
# (bf16, aligned, an H100's 132 SMs): (arch, n) -> {R: form} for the
# decode rows of 1, 8, 32 and 448 slots and one group of 32 and of 448
# tokens.  One block per expert where the expert's rows fit its
# registers; else the spread form from SCORE_EXPERT_SPREAD_MIN_ROWS rows
# per expert; else one cluster per expert.
EXPERT_FORMS = {
    ("granite_moe_1b_a400m", 1024): {1: "expert 1x1", 8: "expert 1x4",
                                     32: "expert 1x16", 448: "spread",
                                     11: "expert 1x6", 141: "spread"},
    ("granite_moe_1b_a400m", 512): {1: "expert 1x1", 8: "expert 1x4",
                                    32: "expert 1x16", 448: "spread",
                                    11: "expert 1x6", 141: "spread"},
    ("granite_moe_3b_a800m", 1536): {1: "expert 1x1", 8: "expert 1x4",
                                     32: "expert 1x16", 448: "spread",
                                     9: "expert 1x5", 113: "spread"},
    ("granite_moe_3b_a800m", 512): {1: "expert 1x1", 8: "expert 1x4",
                                    32: "expert 1x16", 448: "spread",
                                    9: "expert 1x5", 113: "spread"},
    ("jamba_v01_52b", 4096): {1: "expert 2x1", 8: "expert 2x4",
                              32: "spread", 448: "spread",
                              6: "expert 2x4", 71: "spread"},
    ("jamba_v01_52b", 14336): {1: "cluster", 8: "cluster", 32: "spread",
                               448: "spread", 6: "cluster", 71: "spread"},
}


def test_expert_selection_form_at_every_moe_shape():
    """Which form ``score_select_experts`` takes at each expert shape of
    the three MoE archs (the rows ``models/moe.expert_rows`` gives), and
    that each launch fits an H100: threads, shared memory, cluster and
    grid within ``geometry.H100_LIMITS``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    lim = G.H100_LIMITS
    for (arch, n), forms in EXPERT_FORMS.items():
        cfg = get_config(arch)
        E = cfg.num_experts_padded
        assert n in (cfg.d_model, cfg.moe_d_ff)
        rows = {moe.expert_rows(cfg, b, 1) for b in (1, 8, 32, 448)} | \
            {moe.expert_rows(cfg, 1, t) for t in (32, 448)}
        assert rows == set(forms), arch
        for R, want in forms.items():
            nb = n // 128
            for kb in sorted({1, max(1, nb // 2), nb}):
                geo = G.score_select_geometry(E, R, n, 128, kb, 2, True,
                                              lim["sms"], experts=True)
                assert geo.ok and geo.form == want, (arch, n, R, geo)
                assert geo.threads <= lim["threads"]
                assert geo.smem <= lim["smem_optin"]
                assert int(np.prod(geo.cluster)) <= lim["cluster"]
                assert max(geo.grid[1:]) <= lim["grid_yz"]
            # the 2-D entry keeps its one cluster below the spread form's
            # rows
            assert G.score_select_geometry(
                1, R, n, 128, 1, 2, True, lim["sms"]).form == (
                    "spread" if R >= K.SCORE_SPREAD_MIN_ROWS else "cluster")


def test_mirror_constants_match_the_cuda_sources():
    src = (build.CSRC / "score_select.cu").read_text()

    def const(name, text=src):
        (v,) = re.findall(rf"constexpr \w+ {name} = (\d+);", text)
        return int(v)

    assert const("kThreads") == G.SCORE_THREADS
    assert const("kCluster") == G.SCORE_CLUSTER
    assert const("kMaxSmem") == G.SCORE_MAX_SMEM
    assert const("kMaxBlocks") == G.SCORE_MAX_BLOCKS
    assert const("kExpertBlk") == G.SCORE_EXPERT_BLK
    assert const("kExpertWarps") == G.SCORE_EXPERT_WARPS
    assert const("kExpertConfigs") == len(G.SCORE_EXPERT_CONFIGS)

    def table(name):
        (v,) = re.findall(rf"constexpr int {name}\[kExpertConfigs\] = "
                          r"\{([\d,\s]+)\};", src)
        return tuple(int(t) for t in v.split(","))

    assert tuple(zip(table("kExpertNJ"), table("kExpertRU"))) == \
        G.SCORE_EXPERT_CONFIGS
    nj_max = max(nj for nj, _ in G.SCORE_EXPERT_CONFIGS)
    assert const("kExpertMaxBlocks") == G.SCORE_EXPERT_WARPS * nj_max
    gm = (build.CSRC / "gather_mma.cuh").read_text()
    assert const("kThreads", gm) == G.MATMUL_THREADS
    assert "static constexpr int kKC = kPerSeq ? 64 : 128;" in gm
    assert "static constexpr int kStages = kPerSeq ? 4 : 3;" in gm
    # kBytes worked by hand from the Layout fields: bf16 shared
    # 8 rows, f32 shared 32 rows, bf16 per-seq 32 rows
    assert G.matmul_smem(2, 8, False) == 3 * (128 * 136 + 8 * 136) * 2 + 512
    assert G.matmul_smem(4, 32, False) == 3 * (128 * 68 + 32 * 132) * 4 + 512
    assert G.matmul_smem(2, 32, True) == \
        4 * (64 * 136 + 32 * 72) * 2 + (32 * 128 + 260) * 4
    assert "wisparse_launch_info" in build.SIGNATURES


@pytest.mark.parametrize("kernel,args", [
    ("score_select", dict(B=8, n=4096, blk=128, kb=16)),
    ("sparse_matmul_shared", dict(B=8, n=4096, m=1024, blk=128, kb=16,
                                  rows=8, cols=128, splits=4)),
    ("device", {})])
def test_launch_info_passes_the_c_signature(monkeypatch, kernel, args):
    """The query's arguments fit ``build.SIGNATURES`` and its answer is
    read back in the documented order (a stub library stands in for the
    compiled one)."""
    answer = [16, 1, 1, 512, 6108, 16, 1, 1, 3] if kernel != "device" else \
        [1024, 232448, 132, 2147483647, 65535, 65535, 0, 0, 0]

    def query(*a):
        argtypes = build.SIGNATURES["wisparse_launch_info"]
        assert len(a) == len(argtypes)
        for v, t in zip(a, argtypes):
            t.from_param(v)
        assert a[0] == kernel.encode()
        out = ctypes.cast(a[-1], ctypes.POINTER(ctypes.c_int))
        for i, v in enumerate(answer):
            out[i] = v
        return 0

    class Stub:
        wisparse_launch_info = staticmethod(query)

    monkeypatch.setattr(build, "library", lambda: Stub())
    got = G.launch_info(kernel, **args)
    if kernel == "device":
        assert got == {"threads": 1024, "smem_optin": 232448, "sms": 132,
                       "grid_x": 2147483647, "grid_yz": 65535}
    else:
        geo, active = got
        assert geo == G.Geometry((16, 1, 1), 512, 6108, (16, 1, 1))
        assert active == 3
