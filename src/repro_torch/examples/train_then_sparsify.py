"""End-to-end driver (the counterpart of the JAX package's
``examples/train_then_sparsify.py``): train a ~5M-param LM for a few
hundred steps on the synthetic pipeline (with fault-tolerant
checkpointing — a simulated preemption at step 120 restarts
transparently), then apply the full WiSparse pipeline at 30/40/50%
sparsity and report accuracy retention — the paper's Table-1 protocol
on an in-repo model.

    PYTHONPATH=src python -m repro_torch.examples.train_then_sparsify \\
        [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core import pipeline
from repro_torch.core.allocation import EvoConfig
from repro_torch.device import resolve_device
from repro_torch.evals.common import build_calibration, eval_metrics
from repro_torch.launch.train import train

# the recipe: reduced llama31_8b, 8 x 96 tokens a step at lr 5e-3, a
# checkpoint every 50 steps, a simulated preemption at step 120; then
# WiSparse at each sparsity with this search budget
RECIPE = dict(arch="llama31_8b", use_reduced=True, batch=8, seq=96,
              lr=5e-3)
STEPS = 200
CKPT_EVERY = 50
PREEMPT_AT = (120,)
SPARSITIES = (0.3, 0.4, 0.5)
EVO = EvoConfig(generations=4, offspring=8, eps=0.1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_then_sparsify")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is an opt-in)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        params, cfg, data_cfg, hist, final = train(
            **RECIPE, steps=args.steps, ckpt_dir=ckpt_dir,
            ckpt_every=CKPT_EVERY,
            fail_at=PREEMPT_AT,    # simulated preemption -> auto restart
            device=dev)
    print(f"trained: loss {hist[0]['loss']:.3f} -> {final:.3f}")

    ctx, batch = build_calibration(params, cfg, data_cfg)
    dense = eval_metrics(params, cfg, data_cfg, None)
    print(f"dense held-out ppl: {dense['ppl']:.3f}")
    out = {"losses": [h["loss"] for h in hist], "final": final,
           "dense": dense, "wisparse": {}}
    for p in SPARSITIES:
        plan = pipeline.run_pipeline(params, cfg, batch, p, evo=EVO,
                                     delta=0.25, coord_passes=0, ctx=ctx)
        m = eval_metrics(params, cfg, data_cfg, plan.per_depth_sp)
        m["retention"] = dense["ppl"] / m["ppl"]
        out["wisparse"][p] = m
        print(f"WiSparse@{p:.0%}: ppl={m['ppl']:.3f} "
              f"retention={m['retention']:.1%} "
              f"top1-agree={m['top1_agree']:.1%}")
    return out


if __name__ == "__main__":
    main()
