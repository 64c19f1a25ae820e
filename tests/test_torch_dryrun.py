"""The port's dry run (``launch/dryrun.py``, ``launch/cost_analysis.py``,
the mesh half of ``launch/roofline.py``) on a fake process group: the
reference's ``model_flops`` and ``active_matmul_params`` for every
runnable cell; per-device argument bytes worked out from the reference's
specs on ``FakeMesh``; collectives counted on local shards (a
model-sharded cell all-reduces, a 1x1 mesh does not), the same on a
second run in one process; one full-width cell run to ``status: ok``
with its peak-memory estimate; the report's peak and fits columns."""
import math

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import sp_schema as jsp_schema
from repro.distributed import sharding as jsh
from repro.launch import roofline as JR
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro_torch.configs import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.configs import runnable_cells
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from torch_threads import one_thread_module  # noqa: F401 (autouse)

CELLS = runnable_cells()[0]
MESHES = {"single": ((16, 16), ("data", "model"), False),
          "multi": ((2, 16, 16), ("pod", "data", "model"), True)}


class FakeMesh:
    """Just enough of a Mesh for rule resolution (the reference tests')."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def test_model_flops_match_reference_for_every_cell():
    for arch, shp in CELLS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert R.active_matmul_params(cfg) == JR.active_matmul_params(jcfg)
        assert R.model_flops(cfg, SHAPES[shp]) == JR.model_flops(
            jcfg, SHAPES[shp]), (arch, shp)


def _reference_argument_bytes(arch, shp, mesh):
    """Sum over the cell's argument leaves of global bytes over the mesh
    sizes its reference spec shards it by."""
    import jax
    shape_dims, names, _ = MESHES[mesh]
    jcfg, shape = jget_config(arch), SHAPES[shp]
    rules = jsh.LOGICAL_RULES_TRAIN if shape.mode == "train" \
        else jsh.LOGICAL_RULES_SERVE
    ctx = jsh.ShardingCtx(FakeMesh(shape_dims, names), dict(rules))
    sizes = dict(zip(names, shape_dims))
    abstract, axes, _ = japi.abstract_model(jcfg)
    trees = [(axes, abstract)]
    if shape.mode == "train":
        opt = jax.eval_shape(lambda p: jadamw.init(p, jadamw.AdamWConfig()),
                             abstract)
        trees.append(({"m": axes, "v": axes, "master": axes, "step": ()},
                      opt))
    trees.append((japi.input_axes(jcfg, shape), japi.input_specs(jcfg,
                                                                  shape)))
    total = 0
    is_axes = (lambda x: isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x))
    for ax_tree, tree in trees:
        pairs = []
        jax.tree_util.tree_map(lambda a, t: pairs.append((a, t)), ax_tree,
                               tree, is_leaf=is_axes)
        for a, t in pairs:
            spec = jsh.mesh_axes_for(a, t.shape, ctx)
            div = 1
            for entry in spec:
                for name in (entry if isinstance(entry, tuple) else
                             (entry,) if entry else ()):
                    div *= sizes[name]
            total += math.prod(t.shape) * t.dtype.itemsize // div
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
def test_argument_bytes_follow_reference_specs(mesh):
    """Every runnable cell's per-device argument bytes (this rank's local
    shards, on meta) equal the reference specs' arithmetic."""
    shape_dims, _, multi = MESHES[mesh]
    with dryrun.fake_group(math.prod(shape_dims)):
        m = make_production_mesh(multi_pod=multi, device_type="cpu")
        from repro_torch.distributed import sharding as sh
        for arch, shp in CELLS:
            rules = sh.LOGICAL_RULES_TRAIN if SHAPES[shp].mode == "train" \
                else sh.LOGICAL_RULES_SERVE
            with sh.sharding_context(m, rules):
                args = dryrun.cell_args(arch, shp)
                got = dryrun.argument_bytes(args)
            assert got == _reference_argument_bytes(arch, shp, mesh), \
                (arch, shp)


def _small_cell(shape):
    cfg = reduced(get_config("llama31_8b"))
    with dryrun.fake_group(math.prod(shape)):
        return dryrun.dryrun_cell(
            "llama31_8b", "prefill", cfg=cfg,
            shape=ShapeConfig("prefill", 16, 4, "prefill"),
            mesh=make_mesh(shape, device_type="cpu"), verbose=False)


def test_collectives_counted_on_local_shards():
    """A model-sharded mesh all-reduces the row-parallel products' partial
    sums and splits the work; a 1x1 mesh moves nothing and counts the
    whole step on its one rank."""
    sharded, whole = _small_cell((1, 4)), _small_cell((1, 1))
    assert sharded["status"] == whole["status"] == "ok"
    assert sharded["collectives"]["all-reduce"] > 0
    assert sum(whole["collectives"].values()) == 0
    assert 0 < sharded["cost"]["flops_per_device"] \
        < whole["cost"]["flops_per_device"]
    assert sharded["memory"]["argument_bytes"] \
        < whole["memory"]["argument_bytes"]
    assert whole["roofline"]["model_flops"] == sharded["roofline"][
        "model_flops"]


def test_full_width_decode_cell_runs():
    with dryrun.fake_group(256):
        rec = dryrun.dryrun_cell("llama31_8b", "decode_32k", verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mode"] == "decode" and rec["memory"]["argument_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    mem = rec["memory"]
    assert isinstance(mem["peak_bytes_estimate"], int)
    assert isinstance(mem["temp_bytes"], int) and mem["temp_bytes"] >= 0
    assert mem["peak_bytes_estimate"] > mem["argument_bytes"]
    assert mem["peak_bytes_estimate"] == mem["argument_bytes"] \
        + mem["temp_bytes"]


def test_counts_do_not_depend_on_what_ran_before():
    """DTensor's sharding propagation runs each op signature it has not
    cached on fake tensors of the global shapes: neither counter takes
    those, so a cell counts the same on its first and second run in one
    process."""
    cfg = reduced(get_config("llama31_8b"))
    with dryrun.fake_group(4):
        mesh = make_mesh((1, 4), device_type="cpu")
        recs = [dryrun.dryrun_cell(
            "llama31_8b", "train", cfg=cfg,
            shape=ShapeConfig("train", 16, 4, "train"), mesh=mesh,
            verbose=False) for _ in range(2)]
    first, second = ({k: r[k] for k in ("cost", "collectives", "memory")}
                     for r in recs)
    assert first == second


def test_report_shows_peak_and_fit(tmp_path):
    rec = _small_cell((1, 1))
    path = tmp_path / "cells.jsonl"
    import json
    path.write_text(json.dumps(rec) + "\n" + json.dumps(
        rec | {"mesh": "multi", "memory": rec["memory"] | {
            "peak_bytes_estimate": 81 * 10**9}}) + "\n")
    table = dryrun.report(str(path))
    peak = rec["memory"]["peak_bytes_estimate"] / 2**30
    assert f"peak {peak:.2f} GiB (fits 80 GB)" in table
    assert "peak 75.44 GiB (does not fit 80 GB)" in table


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_over_two_layer_groups_matches_no_remat(remat):
    """gemma3_4b's dry-run train cell found it: with two layer groups
    (a 6-layer period and a 1-layer tail), remat's recompute in the
    backward must run each group's own layers, not the last group's."""
    import dataclasses

    import torch

    from repro_torch.models import api
    from repro_torch.models import params as P
    cfg = dataclasses.replace(reduced(get_config("gemma3_4b")), num_layers=7)
    assert len(cfg.layer_groups()) == 2
    params = api.init_model(cfg, 0, device="cpu")
    toks = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))}
    leaves = P.tree_leaves(params)
    grads = {}
    for mode in ("none", remat):
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = api.make_loss_fn(cfg, mode)(params, toks)
        grads[mode] = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
    for a, b in zip(grads["none"], grads[remat], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
