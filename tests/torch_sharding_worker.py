"""One rank of ``tests/test_torch_sharding_ranks.py``: a process group of
the mesh's size, a mesh of the given shape, and the port's steps on
DTensors placed by the logical-axis rules.  Imports torch and the port
only (no JAX): the test process computes the JAX references and
compares.

Inputs (``torch.load`` of ``inputs.pt`` in the work directory): per arch
the params, the tokens, seeded grads (to feed the sharded optimizer),
the decode plan (cache length, steps).  Rank 0 writes ``out.pt``: per
arch the loss and grads under ``LOGICAL_RULES_TRAIN``, the params after
one AdamW step, the prefill logits, the decode logits and greedy tokens
under ``LOGICAL_RULES_SERVE``, gathered whole; and the row-parallel
grouped top-k on a model-sharded weight beside the unsharded call.

On cards, as a script: ``python tests/torch_sharding_worker.py --mesh
2x2`` starts one NCCL rank per card of the mesh, runs the same steps on
reduced llama31_8b, granite_moe_3b_a800m and mamba2_130m (f32, seeded
inputs) and holds rank 0's sharded results against the same steps run
unsharded on its card (rtol = atol = 1e-5, tokens equal); it prints the
largest differences and exits nonzero on a mismatch."""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import torch
import torch.distributed as dist

ARCHS = ("llama31_8b", "granite_moe_3b_a800m", "mamba2_130m")
TOL = 1e-5


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def run_arch(arch, inp, mesh=None):
    """The steps of one arch on ``mesh`` (None: unsharded), their
    results whole on this rank."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import sparse_linear as sl
    from repro_torch.distributed.sharding import (LOGICAL_RULES_SERVE,
                                                  LOGICAL_RULES_TRAIN,
                                                  distribute, full, place,
                                                  sharding_context)
    from repro_torch.models import api
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.optim import adamw
    from repro_torch.sparsity import SparsityPolicy

    def context(rules):
        return contextlib.nullcontext() if mesh is None else \
            sharding_context(mesh, rules)

    cfg = reduced(get_config(arch))
    axes = P.logical_axes(M.model_schema(cfg))
    toks = inp["tokens"]
    dev = toks.device
    out = {}
    with context(LOGICAL_RULES_TRAIN):
        # a copy: the optimizer writes the params in place, and a placed
        # shard may share memory with the tensor it came from
        params = distribute(P.tree_map(torch.clone, inp["params"]), axes)
        leaves = P.tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = api.make_loss_fn(cfg)(params, {"tokens": toks})
        grads = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        out["loss"] = full(loss).item()
        out["grads"] = [full(g) for g in grads]
        # one AdamW step on sharded state, fed the given grads
        # (replicated: the update redistributes them to the state's layout)
        state = adamw.init(params, adamw.AdamWConfig())
        grads = P.tree_unflatten_like(params, [
            place(g, (None,) * g.dim()) for g in inp["grads"]])
        params, state, _ = adamw.update(grads, state, params,
                                        adamw.AdamWConfig())
        out["adamw"] = [full(p) for p in P.tree_leaves(params)]
    T, steps = inp["cache_len"], inp["steps"]
    B, S = toks.shape
    with context(LOGICAL_RULES_SERVE):
        params = distribute(inp["params"], axes)
        logits, caches = api.make_prefill_step(cfg)(params, toks)
        out["prefill"] = full(logits)
        caches = api.pad_caches(cfg, caches, B, T)
        tok = full(logits).argmax(-1)
        dec, toks_out = [], []
        for i in range(steps):
            step = api.make_decode_step(cfg, aligned=i < steps - 1)
            logits, caches = step(params, {
                "tokens": tok, "positions": torch.full((B,), S + i,
                                                       device=dev),
                "caches": caches})
            logits = full(logits)
            dec.append(logits)
            tok = logits.argmax(-1)
            toks_out.append(tok)
        out["decode"] = dec
        out["tokens"] = toks_out
    if arch == "llama31_8b" and mesh is not None:
        # the grouped top-k of a row-parallel weight, sharded over model,
        # beside the same call unsharded
        g = torch.Generator().manual_seed(3)
        x = torch.randn(B, S, 128, generator=g).to(dev)
        w = torch.randn(128, 64, generator=g).to(dev)
        sp = sl.default_sp(w)
        sp["alpha"] = torch.tensor(0.5, device=dev)
        sp["keep_frac"] = torch.tensor(0.75, device=dev)
        pol = SparsityPolicy.uniform("topk_shared", k_max_frac=0.5)
        with context(LOGICAL_RULES_SERVE):
            y = sl.project(place(x, ("batch", None, "embed_act")),
                           place(w, ("mlp", "embed")),
                           {k: place(v, ("mlp",) if v.dim() else ())
                            for k, v in sp.items()},
                           True, policy=pol)
            out["grouped"] = full(y)
        G = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        out["grouped_ref"] = sl._topk_gather_grouped(x, w, sp, pol, G)
    return out


def worker(rank: int, world: int, init_file: str, shape, work: str,
           device: str = "cpu"):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh
        dev = torch.device(device, rank) if device == "cuda" \
            else torch.device("cpu")
        mesh = make_mesh(shape, device_type=device)
        inputs = _to(torch.load(os.path.join(work, "inputs.pt")), dev)
        outs = {arch: run_arch(arch, inp, mesh)
                for arch, inp in inputs.items()}
        if rank == 0:
            torch.save(_to(outs, "cpu"), os.path.join(work, "out.pt"))
    finally:
        dist.destroy_process_group()


def seeded_inputs(arch, batch=4, seq=16, cache_len=24, steps=3):
    """Params from the port's init (any weights hold two runs to each
    other), tokens and optimizer grads, all from seeds."""
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    cfg = reduced(get_config(arch))
    params = P.init_params(M.model_schema(cfg), 0)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32) * 1e-2) for p in P.tree_leaves(params)]
    return {"params": params, "tokens": torch.from_numpy(toks).long(),
            "grads": grads, "cache_len": cache_len, "steps": steps}


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> int:
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="2x2", help="DATAxMODEL, e.g. 2x2")
    args = ap.parse_args(argv)
    shape = tuple(int(a) for a in args.mesh.split("x"))
    world = shape[0] * shape[1]
    if torch.cuda.device_count() < world:
        print(f"needs {world} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        inputs = {a: seeded_inputs(a) for a in ARCHS}
        torch.save(inputs, os.path.join(work, "inputs.pt"))
        mp.spawn(worker, args=(world, os.path.join(work, "init"), shape,
                               work, "cuda"), nprocs=world)
        outs = torch.load(os.path.join(work, "out.pt"))
    dev = torch.device("cuda", 0)
    bad = 0
    for arch in ARCHS:
        ref = run_arch(arch, _to(inputs[arch], dev))
        got = _to(outs[arch], dev)
        diffs = {"loss": abs(got["loss"] - ref["loss"]),
                 "grads": max(map(_max_diff, got["grads"], ref["grads"])),
                 "adamw": max(map(_max_diff, got["adamw"], ref["adamw"])),
                 "prefill": _max_diff(got["prefill"], ref["prefill"]),
                 "decode": max(map(_max_diff, got["decode"],
                                   ref["decode"]))}
        same = all(torch.equal(a, b) for a, b in zip(got["tokens"],
                                                     ref["tokens"]))
        if "grouped" in got:
            diffs["grouped"] = _max_diff(got["grouped"], got["grouped_ref"])
        ok = same and all(v <= TOL for v in diffs.values())
        bad += not ok
        print(f"{arch} on a {args.mesh} mesh of {world} cards "
              f"({torch.cuda.get_device_name(0)}): largest differences "
              + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
              + f"; tokens {'equal' if same else 'DIFFER'}"
              + ("" if ok else "  <- FAIL"), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    sys.exit(main())
