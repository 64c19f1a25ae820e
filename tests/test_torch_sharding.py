"""The port's logical-axis sharding rules (``distributed/sharding.py``)
against the JAX package's, and the pieces of the sharding slice that run
without a multi-rank group: the row-parallel grouped top-k, the
``aligned`` decode cache write, and checkpoint restore under a context.

Rules resolve on the reference tests' ``FakeMesh`` (``tests/test_sharding.py``):
every param, input, cache and sp leaf of every arch x shape, on the
single (16, 16) and multi-pod (2, 16, 16) meshes, under both rule sets,
gives the reference's spec entry for entry.  Multi-rank runs are in
``tests/test_torch_sharding_ranks.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import sp_schema as jsp_schema
from repro.core.sparse_linear import _topk_gather_grouped as j_grouped
from repro.distributed import sharding as jsh
from repro.launch.serve import _pad_caches as jpad_caches
from repro.models import api as japi
from repro.sparsity import SparsityPolicy as JPolicy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.core import sp_schema
from repro_torch.core import sparse_linear as sl
from repro_torch.distributed import sharding as sh
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.sparsity import SparsityPolicy
from torch_threads import one_thread_module  # noqa: F401 (autouse)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"train": (sh.LOGICAL_RULES_TRAIN, jsh.LOGICAL_RULES_TRAIN),
         "serve": (sh.LOGICAL_RULES_SERVE, jsh.LOGICAL_RULES_SERVE)}


class FakeMesh:
    """Just enough of a Mesh for rule resolution (the reference tests')."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _ctxs(mesh, rules):
    shape, names = MESHES[mesh]
    port, ref = RULES[rules]
    return (sh.ShardingCtx(FakeMesh(shape, names), dict(port)),
            jsh.ShardingCtx(FakeMesh(shape, names), dict(ref)))


def _ref_entries(spec: JP) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _jax_leaves(axes_tree, tree):
    """[(axes, shape)] of a JAX axes tree and its abstract tree."""
    out = []

    def f(axes, aval):
        out.append((axes, tuple(aval.shape)))
    jax.tree_util.tree_map(f, axes_tree, tree,
                           is_leaf=lambda x: isinstance(x, tuple) and all(
                               isinstance(a, (str, type(None))) for a in x))
    return out


def _port_leaves(axes_tree, tree):
    leaves = dict(P.tree_flatten_with_path(tree))
    return [(axes, tuple(leaves[p].shape))
            for p, axes in sh.axes_leaves(axes_tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference_for_every_leaf(arch):
    """Every param, input, cache and sp leaf of ``arch`` x every shape x
    both meshes x both rule sets: the port's abstract trees carry the
    reference's axes and shapes, and resolve to its specs."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jabs, jaxes, _ = japi.abstract_model(jcfg)
    pabs, paxes, _ = api.abstract_model(cfg)
    jsp_abs, jsp_axes = jsp_schema.abstract_sp(jcfg)
    psp_abs, psp_axes = sp_schema.abstract_sp(cfg)
    jl = _jax_leaves(jaxes, jabs) + _jax_leaves(jsp_axes, jsp_abs)
    pl = _port_leaves(paxes, pabs) + _port_leaves(psp_axes, psp_abs)
    for shape in SHAPES.values():
        jl_s = _jax_leaves(japi.input_axes(jcfg, shape),
                           japi.input_specs(jcfg, shape))
        pl_s = _port_leaves(api.input_axes(cfg, shape),
                            api.input_specs(cfg, shape))
        assert sorted(pl_s, key=repr) == sorted(jl_s, key=repr), shape.name
    assert sorted(pl, key=repr) == sorted(jl, key=repr)
    leaves = set(jl)
    for shape in SHAPES.values():
        leaves |= set(_jax_leaves(japi.input_axes(jcfg, shape),
                                  japi.input_specs(jcfg, shape)))
    n = 0
    for mesh in MESHES:
        for rules in RULES:
            pctx, jctx = _ctxs(mesh, rules)
            for axes, shp in sorted(leaves, key=repr):
                assert sh.mesh_axes_for(axes, shp, pctx) == _ref_entries(
                    jsh.mesh_axes_for(axes, shp, jctx)), (axes, shp, mesh)
                n += 1
    assert n > 0


# the reference's own rule cases (tests/test_sharding.py)
CASES = [
    ("train", "single", ("embed", "mlp"), (8192, 22016), ("data", "model")),
    ("train", "single", ("batch", None, "heads", None), (256, 4096, 8, 256),
     ("data", None, None, None)),
    ("serve", "single", ("batch", "kv_seq", "kv_heads", None),
     (128, 32768, 8, 128), ("data", "model", None, None)),
    ("train", "multi", ("batch", "seq"), (256, 4096),
     (("pod", "data"), None)),
    ("serve", "single", ("batch", "kv_seq", "kv_heads", None),
     (1, 524288, 4, 256), (None, ("data", "model"), None, None)),
    ("train", "single", ("experts", "embed", "expert_mlp"), (32, 1024, 512),
     ("model", "data", None)),
    ("train", "single", ("experts", "embed", "expert_mlp"), (40, 1536, 512),
     (None, "data", "model")),
]


@pytest.mark.parametrize("rules,mesh,axes,shape,want", CASES, ids=[
    "divisible", "indivisible_replicates", "axis_once_per_array",
    "multipod_batch", "batch_one_seq_shards", "moe_experts",
    "moe_expert_mlp_fallback"])
def test_reference_rule_cases(rules, mesh, axes, shape, want):
    pctx, jctx = _ctxs(mesh, rules)
    assert sh.mesh_axes_for(axes, shape, pctx) == want
    assert _ref_entries(jsh.mesh_axes_for(axes, shape, jctx)) == want


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None), ["S0", "S0", "R"]),
    ((None, ("data", "model")), ["R", "S1", "S1"]),
    (("model", "data", None), ["R", "S1", "S0"]),
    ((None, None), ["R", "R", "R"]),
])
def test_placements_of_specs(spec, want):
    """A spec entry naming several mesh axes shards its dim over each of
    them (major first, the mesh's order)."""
    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    got = ["R" if p.is_replicate() else f"S{p.dim}"
           for p in sh.placements(spec, mesh)]
    assert got == want


def test_constrain_noop_without_context():
    x = torch.ones(4, 4)
    assert sh.current_ctx() is None
    assert sh.constrain(x, "batch", None) is x
    assert sh.mesh_axes_for(("batch", "mlp"), (4, 4)) == (None, None)


@pytest.mark.parametrize("backend", ["topk_shared", "topk_block"])
@pytest.mark.parametrize("G", [2, 4])
def test_grouped_topk_matches_reference(backend, G):
    """A row-parallel projection under a context whose ``model`` axis has
    size G takes the balanced per-shard selection, equal to the
    reference's ``_topk_gather_grouped(groups=G)``."""
    rng = np.random.default_rng(G)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    w = rng.standard_normal((256, 48)).astype(np.float32)
    g = np.sqrt((w * w).sum(1)).astype(np.float32)
    sp = {"g": g, "alpha": np.float32(0.7), "tau": np.float32(-np.inf),
          "keep_frac": np.float32(0.6)}
    jpol = JPolicy.uniform(backend, k_max_frac=0.5, block=16)
    want = np.asarray(j_grouped(jnp.asarray(x), jnp.asarray(w),
                                {k: jnp.asarray(v) for k, v in sp.items()},
                                jpol, G))
    pol = SparsityPolicy.uniform(backend, k_max_frac=0.5, block=16)
    tsp = {k: torch.tensor(v) for k, v in sp.items()}
    with sh.sharding_context(FakeMesh((1, G), ("data", "model")),
                             sh.LOGICAL_RULES_SERVE):
        got = sl.project(torch.from_numpy(x), torch.from_numpy(w), tsp,
                         True, policy=pol)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # without the flag (or the context) the plain top-k path runs
    flat = sl.project(torch.from_numpy(x), torch.from_numpy(w), tsp,
                      True, policy=pol)
    assert not np.allclose(flat.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama31_8b", "gemma2_2b"])
def test_aligned_decode_matches_reference(arch):
    """``make_decode_step(aligned=True)``: one slice write per cache, at
    ``positions[0]`` (rolling on gemma2's local layers: the prompt is
    past the reduced window of 32), equal to the reference's aligned
    step, and the per-row write gives the same caches."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    B, S, T = 2, 40, 44
    params = P.init_params(api.M.model_schema(cfg), 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, P.to_numpy(params))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jax.jit(japi.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    jc = jpad_caches(jcfg, jc, B, T)
    jstep = jax.jit(japi.make_decode_step(jcfg, aligned=True))
    lg, caches = api.make_prefill_step(cfg)(params, torch.from_numpy(toks))
    caches = api.pad_caches(cfg, caches, B, T)
    other = P.tree_map(torch.clone, caches)
    step = api.make_decode_step(cfg, aligned=True)
    rows = api.make_decode_step(cfg)
    tok = lg.argmax(-1)
    jtok = jnp.asarray(tok.numpy().astype(np.int32))
    for i in range(3):
        pos = torch.full((B,), S + i)
        batch = {"tokens": tok, "positions": pos, "caches": caches}
        lg, caches = step(params, batch)
        rows(params, {**batch, "caches": other})
        jlg, jc = jstep(jparams, {"tokens": jtok, "positions": jnp.full(
            (B,), S + i, jnp.int32), "caches": jc})
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-5,
                                   atol=1e-5)
        tok = lg.argmax(-1)
        jtok = jnp.argmax(jlg, -1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for a, b, c in zip(P.tree_leaves(caches), P.tree_leaves(other),
                       jax.tree_util.tree_leaves(jc), strict=True):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture
def fake_mesh():
    """A 2x2 mesh over a fake group of four ranks (this process is rank
    0): placement needs no communication."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_mesh((2, 2), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_restore_under_context_places_by_rules(fake_mesh, tmp_path):
    """``restore(axes_tree=)`` inside a context places each listed leaf
    by the current mesh's rules (rank 0's shard holds the saved values'
    first chunk); outside a context it restores plain tensors."""
    cfg = reduced(get_config("granite_moe_1b_a400m"))
    params = api.init_model(cfg, 0, device="cpu")
    _, axes, _ = api.abstract_model(cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params)
    with sh.sharding_context(fake_mesh, sh.LOGICAL_RULES_TRAIN) as ctx:
        got, meta = mgr.restore(params, axes_tree=axes)
        assert meta["step"] == 3
        for (path, axes_), leaf in zip(sh.axes_leaves(axes),
                                       P.tree_leaves(got), strict=True):
            want = dict(P.tree_flatten_with_path(params))[path]
            ns = sh.named_sharding(axes_, want.shape, ctx)
            assert tuple(leaf.placements) == ns.placements, path
            chunk = want
            for d, entry in enumerate(ns.spec):
                n = 1 if entry is None else int(np.prod(
                    [2 for _ in (entry if isinstance(entry, tuple)
                                 else (entry,))]))
                chunk = chunk.narrow(d, 0, want.shape[d] // n)
            assert torch.equal(leaf.to_local(), chunk), path
    plain, _ = mgr.restore(params, axes_tree=axes)
    for a, b in zip(P.tree_leaves(plain), P.tree_leaves(params)):
        assert type(a) is torch.Tensor and torch.equal(a, b)
