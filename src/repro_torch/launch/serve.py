"""Serving CLI for the port: a thin front end over the continuous-batching
engine (``repro_torch.serving``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31_8b \\
        --mode pallas --sparsity 0.5 --batch 8 --prompt-len 128 --gen 32

Full width and the card are the defaults; ``--reduced`` (the tiny
same-family config) and ``--device cpu`` are opt-ins.  Weights are random
from ``--seed``.  The paper's §5.1 recipe applies: the first half of each
prompt prefills dense, later chunks and every decode step run under the
``--mode`` backend.

Without calibration the sp tree is built from the weights
(``default_sp_stacked``): g = column norms, alpha = 1, keep_frac =
1 - sparsity.  Its threshold tau is set to -inf for ``pallas`` (the
reference's uncalibrated +inf would zero every projection that
backend runs), so ``pallas`` sparsity comes from the block top-k at
keep_frac alone.  ``mask`` thresholds on tau and needs calibration, so
uncalibrated it falls back to ``topk_shared``, as the reference CLI does.
Calibration, ladders, the gateway and telemetry come with later slices.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import Engine, EngineConfig
from repro_torch.sparsity import SparsityPolicy


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama31_8b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny same-family config instead of "
                         "the full-width one")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is an opt-in)")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--mode", default="pallas",
                    choices=["mask", "topk_shared", "topk_block", "pallas"])
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to submit")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def validate_args(args) -> None:
    if not 0.0 <= args.sparsity < 1.0:
        raise SystemExit(f"--sparsity must be in [0, 1), got {args.sparsity}")
    for name in ("prompt-len", "gen", "batch"):
        v = getattr(args, name.replace("-", "_"))
        if v <= 0:
            raise SystemExit(f"--{name} must be > 0, got {v}")


def build_policy(args, params, cfg):
    """(policy, sp) for the flags; prints what it chose and why."""
    if args.sparsity == 0:
        return SparsityPolicy.dense(), None
    mode = args.mode
    if mode == "mask":
        print("mask needs calibrated thresholds -> using topk_shared")
        mode = "topk_shared"
    tau = float("-inf") if mode == "pallas" else float("inf")
    if mode == "pallas":
        print("pallas: sp tree with tau=-inf (uncalibrated; the reference's "
              "tau=+inf would zero every projection), sparsity from the "
              f"block top-k at keep_frac={1.0 - args.sparsity}")
    sp = default_sp_stacked(params, cfg, keep_frac=1.0 - args.sparsity,
                            tau=tau)
    return SparsityPolicy.uniform(mode, k_max_frac=1.0 - args.sparsity), sp


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_args(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = api.init_model(cfg, args.seed, device=device)
    policy, sp = build_policy(args, params, cfg)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    # one slot per request, room for prompt + generation
    ecfg = EngineConfig(max_slots=args.batch,
                        max_len=args.prompt_len + args.gen, policy=policy)
    engine = Engine(params, cfg, ecfg, sp, device=device)
    t0 = obs.now()
    for b in range(args.batch):
        engine.submit(prompts[b], args.gen)
    out = engine.run()
    dt = obs.now() - t0
    n = sum(len(t) for t in out.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"generated {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s on "
          f"{where})")
    print("engine stats:", engine.stats.summary())
    print("sample:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
