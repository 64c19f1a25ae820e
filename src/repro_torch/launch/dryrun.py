"""Dry run of every (architecture x input shape x mesh) cell: the cell's
step on abstract inputs (meta tensors, no storage) placed on a production
mesh by the logical-axis rules, counted per device (port of the JAX
package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek_67b \\
        --shape decode_32k --mesh single --sparsity 0.5
    PYTHONPATH=src python -m repro_torch.launch.dryrun --report results.jsonl

One host process stands for the whole mesh: a fake process group of 256
(single pod, (16, 16) over ``("data", "model")``) or 512 ranks (two
pods, ``("pod", "data", "model")``) in which this process is rank 0 and
collectives move nothing, as the reference forces 512 host devices.  It
is a host-only tool, by design, not a fallback from the card.  Params,
optimizer state, inputs, caches and the sp tree come from the abstract
builders (``api.abstract_model``, ``api.input_specs``,
``sp_schema.abstract_sp``) as meta tensors, placed by the mode's rules
(``LOGICAL_RULES_TRAIN`` for train, ``LOGICAL_RULES_SERVE`` otherwise),
and the cell's step runs once on them (train: loss, grads and AdamW
under ``--remat``; prefill; decode, ``aligned`` unless ``--no-aligned``;
``topk_shared`` at ``k_max_frac = 1 - sparsity`` when sparse).

A record keeps the reference's keys where their meaning holds: ``arch``,
``shape``, ``mesh``, ``mode``, ``chips``, ``sparsity``, ``remat``,
``status``, ``memory.argument_bytes`` / ``output_bytes`` (this rank's
shards of the step's arguments and results), ``cost.flops_per_device``
/ ``bytes_per_device`` (counted on local shards), ``collectives`` and
``roofline`` (H100 SXM data-sheet predictions).  The step runs once
under ``CommDebugMode``, ``CostCounter`` and
``memory_analysis.PeakCounter`` together, and the last gives
``memory.peak_bytes_estimate`` (the most bytes alive on this rank at
once, the arguments included, as the reference's "per-device peak")
and ``memory.temp_bytes`` (that peak less the arguments' bytes: what
the step holds above its arguments), beside ``peak_op`` (the op at the
peak).  Both differ from XLA's numbers by design: eager torch fuses
nothing, so every intermediate an op writes counts while it lives,
where XLA keeps a fusion's intermediates on chip; and the port's decode
and train steps write the caches, params and optimizer state in place,
where the reference donates them to buffers it may reuse.  An op's
internal workspace (freed inside the op) and the caching allocator's
512-byte granules are not in them; ``chip_smoke.py`` holds them against
``torch.cuda.max_memory_allocated`` on the card.  The reference's
``xla_flops`` / ``xla_bytes`` have no counterpart and are left out;
``host_s`` (this process's time for the cell) replaces ``compile_s``.
``--no-donate`` is accepted for the reference's CLI: the port's decode
writes its caches in place either way.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, runnable_cells
from repro_torch.core import sp_schema
from repro_torch.distributed import sharding as sh
from repro_torch.launch import roofline as R
from repro_torch.launch.constants import CARD_HBM_BYTES
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.memory_analysis import PeakCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.obs.clock import now
from repro_torch.optim import adamw
from repro_torch.sparsity import SparsityPolicy


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0):
    collectives return at once and move nothing.  A process group
    already running is an error."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the dry "
                           f"run starts its own of {world} ranks")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    total = 0
    for t in P.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = sh.local(t)
            total += t.numel() * t.element_size()
    return total


def cell_args(arch: str, shape_name: str, *, sparsity: float = 0.0,
              cfg=None, shape=None, device: str = "meta"):
    """The placed arguments of a cell, inside an active sharding context:
    {"params", "opt_state" (train), "batch", "sp" (sparse serve)}, each
    a tree of DTensors whose local shards are meta tensors
    (``device="meta"``) or zeros on ``device``."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    sparse = sparsity > 0.0 and shape.mode != "train"

    def build(tree):
        if device == "meta":
            return tree
        return P.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                device=device), tree)

    abstract, axes, _ = api.abstract_model(cfg)
    args = {"params": sh.distribute(build(abstract), axes)}
    if shape.mode == "train":
        args["opt_state"] = adamw.init(args["params"], adamw.AdamWConfig())
    args["batch"] = sh.distribute(build(api.input_specs(cfg, shape)),
                                  api.input_axes(cfg, shape))
    if sparse:
        sp_abs, sp_axes = sp_schema.abstract_sp(cfg)
        args["sp"] = sh.distribute(build(sp_abs), sp_axes)
    return args


def argument_bytes(args) -> int:
    """This rank's bytes of a cell's arguments (:func:`cell_args`)."""
    return _local_bytes(list(args.values()))


def cell_step(cfg, shape, *, sparsity: float = 0.0, remat: str = "dots",
              aligned: bool = True):
    """The step a cell runs, as ``run(args)`` on :func:`cell_args`'s
    arguments: train (loss, grads, AdamW under ``remat``), prefill, or
    decode (``aligned`` one-slice cache writes); ``topk_shared`` at
    ``k_max_frac = 1 - sparsity`` when a serve cell is sparse."""
    train = shape.mode == "train"
    policy = SparsityPolicy.uniform(
        "topk_shared", k_max_frac=max(1.0 - sparsity, 1e-6)) \
        if sparsity > 0.0 and not train else SparsityPolicy.dense()
    step, _ = api.step_for_shape(
        cfg, shape, remat=remat, policy=policy,
        aligned=aligned and shape.mode == "decode")

    def run(args):
        call = [args["params"]] + (
            [args["opt_state"]] if train else []) + [args["batch"]]
        return step(*call, args.get("sp"))
    return run


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                sparsity: float = 0.0, remat: str = "dots",
                overrides=None, verbose: bool = True, aligned: bool = True,
                cfg=None, shape=None, mesh=None):
    """Run one cell on abstract inputs.  Returns a result record (dict).
    ``cfg``/``shape``/``mesh`` override the named ones (tests run cut
    configs on small meshes); the default mesh needs a process group of
    256 (512 with ``multi_pod``) ranks (:func:`fake_group`)."""
    t0 = now()
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, device_type="cpu")
    mesh_name = "multi" if multi_pod else "single"
    train = shape.mode == "train"
    rules = sh.LOGICAL_RULES_TRAIN if train else sh.LOGICAL_RULES_SERVE
    sparse = sparsity > 0.0 and not train
    chips = math.prod(mesh.shape)
    with sh.sharding_context(mesh, rules, overrides):
        args = cell_args(arch, shape_name, sparsity=sparsity, cfg=cfg,
                         shape=shape)
        run = cell_step(cfg, shape, sparsity=sparsity, remat=remat,
                        aligned=aligned)
        arg_bytes = argument_bytes(args)
        from torch.distributed.tensor.debug import CommDebugMode
        with CommDebugMode() as comm, CostCounter() as counter, \
                PeakCounter(args) as peak:
            out = run(args)
        out_bytes = _local_bytes(list(out) if isinstance(out, tuple)
                                 else out)
        del out
    cost = counter.summary()
    coll = cost.pop("collectives")
    rl = R.Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=cost["flops_per_device"],
        bytes_per_device=cost["bytes_per_device"],
        coll_bytes=R.wire_bytes(coll),
        model_flops_total=R.model_flops(cfg, shape))
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "mode": shape.mode, "chips": chips,
        "sparsity": sparsity if sparse else 0.0,
        "remat": remat if train else None,
        "overrides": {k: list(map(list, v))
                      for k, v in (overrides or {}).items()},
        "status": "ok",
        "host_s": now() - t0,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak.temp_bytes,
                   # per-device peak of live bytes (includes arguments)
                   "peak_bytes_estimate": peak.peak_bytes,
                   "peak_op": peak.peak_op},
        "cost": {"flops_per_device": cost["flops_per_device"],
                 "bytes_per_device": cost["bytes_per_device"]},
        "collectives": coll,
        "collective_counts": cost["collective_counts"],
        "comm_debug_counts": {str(k): v for k, v in
                              comm.get_comm_counts().items()},
        "roofline": rl.row(),
    }
    if verbose:
        gb = peak.peak_bytes / 2**30
        print(f"[{arch} x {shape.name} x {mesh_name}"
              f"{' sparse@%.2f' % sparsity if sparse else ''}] "
              f"host={rec['host_s']:.1f}s peak={gb:.2f}GiB/device "
              f"compute={rl.compute_s*1e3:.2f}ms "
              f"memory={rl.memory_s*1e3:.2f}ms "
              f"coll={rl.collective_s*1e3:.2f}ms -> {rl.bottleneck} "
              f"(useful={rl.useful_flops_ratio:.2f} mfu={rl.mfu:.3f})",
              flush=True)
    return rec


def report(path: str) -> str:
    """A markdown table of the records in ``path`` (one row per arch x
    shape, the single-pod and two-pod meshes side by side): per-device
    peak GiB and whether it fits one card's ``CARD_HBM_BYTES``, argument
    GiB, TFLOPs, collective GB on the wire, the bottleneck and ``mfu``;
    the roofline terms are H100 SXM data-sheet predictions."""
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def cell(r):
        if r is None:
            return "—"
        if r["status"] != "ok":
            return f"error: {r['error'][:60]}"
        rl, mem = r["roofline"], r["memory"]
        fits = "fits" if mem["peak_bytes_estimate"] <= CARD_HBM_BYTES \
            else "does not fit"
        return (f"peak {mem['peak_bytes_estimate'] / 2**30:.2f} GiB "
                f"({fits} {CARD_HBM_BYTES / 1e9:.0f} GB), "
                f"args {mem['argument_bytes'] / 2**30:.2f} GiB, "
                f"{r['cost']['flops_per_device'] / 1e12:.3f} TF, "
                f"{R.wire_bytes(r['collectives']) / 1e9:.3f} GB; "
                f"{rl['bottleneck']}, mfu {rl['mfu']:.4f}")
    out = ["| arch | shape | single (16x16) | multi (2x16x16) |",
           "|---|---|---|---|"]
    for (arch, shp), by_mesh in rows.items():
        out.append(f"| {arch} | {shp} | {cell(by_mesh.get('single'))} | "
                   f"{cell(by_mesh.get('multi'))} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--no-aligned", dest="aligned", action="store_false",
                    help="per-sequence decode positions (per-row writes)")
    ap.add_argument("--no-donate", dest="donate", action="store_false",
                    help="accepted for the reference's CLI; the decode "
                         "step writes its caches in place either way")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out")
    ap.add_argument("--report", default=None, metavar="JSONL",
                    help="print a markdown table of these records, and "
                         "stop")
    args = ap.parse_args(argv)
    if args.report:
        print(report(args.report))
        return

    if args.all:
        cells, skips = runnable_cells()
        for arch, shp, why in skips:
            print(f"SKIP {arch} x {shp}: {why}", flush=True)
    else:
        if args.arch is None or args.shape is None:
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("sparsity", 0.0)))
                except (ValueError, KeyError):
                    pass

    t0 = now()
    failures = 0
    for mp in meshes:
        mname = "multi" if mp else "single"
        with fake_group(512 if mp else 256):
            for arch, shp in cells:
                key = (arch, shp, mname, args.sparsity
                       if SHAPES[shp].mode != "train" else 0.0)
                if key in done:
                    print(f"skip (done): {key}", flush=True)
                    continue
                try:
                    rec = dryrun_cell(arch, shp, multi_pod=mp,
                                      sparsity=args.sparsity,
                                      remat=args.remat,
                                      aligned=args.aligned)
                except Exception as e:       # noqa: BLE001 - recorded
                    failures += 1
                    rec = {"arch": arch, "shape": shp, "mesh": mname,
                           "sparsity": args.sparsity, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[{arch} x {shp} x {mname}] FAILED: "
                          f"{type(e).__name__}: {e}", flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    print(f"dry run: {len(cells) * len(meshes)} cells in "
          f"{now() - t0:.1f}s host time, {failures} failed", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
