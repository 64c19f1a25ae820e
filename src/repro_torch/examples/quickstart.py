"""Quickstart: WiSparse in the port in ~50 lines (the counterpart of the
JAX package's ``examples/quickstart.py``).

Builds a small model, calibrates weight-aware scores and thresholds at
50% sparsity (paper Alg. 1-4, a tiny search budget), applies the
per-token threshold mask (paper Eq. 4/5) and compares against the dense
output.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline
from repro_torch.core import unstacked as U
from repro_torch.core.allocation import EvoConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.sparsity import SparsityPolicy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is an opt-in)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a small llama-style model (same family as the paper's Llama-3.1-8B)
    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, seed=0, device=dev)

    # 2. calibration data (synthetic here; pile-val/CodeAlpaca in the paper)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))).to(dev)
    batch = {"tokens": tokens}

    # 3. one-call WiSparse: weight-aware scores + thresholds at 50% sparsity
    #    (tiny search budget so the demo runs in seconds)
    plan = pipeline.run_pipeline(
        params, cfg, batch, p_target=0.5,
        evo=EvoConfig(generations=2, offspring=4, eps=0.1),
        delta=0.25, coord_passes=0, log=print)
    print("block-level prune ratios:", np.round(plan.block_ratios, 3))

    # 4. run the sparse model (per-token masks, Eq. 5) and compare to dense.
    #    The execution backend is an explicit SparsityPolicy value passed
    #    alongside the sp params.
    with torch.no_grad():
        dense_logits, _ = U.forward_unstacked(params, cfg, tokens)
        sparse_logits, _ = U.forward_unstacked(
            params, cfg, tokens, per_depth_sp=plan.per_depth_sp,
            policy=SparsityPolicy.uniform("mask"))
    pd = torch.log_softmax(dense_logits.float(), -1)
    ps = torch.log_softmax(sparse_logits.float(), -1)
    kl = float(torch.mean(torch.sum(torch.exp(pd) * (pd - ps), -1)))
    agree = float((pd.argmax(-1) == ps.argmax(-1)).float().mean())
    print(f"50% sparsity: KL(dense||sparse)={kl:.5f}, "
          f"top-1 agreement={agree:.1%}")
    if not np.isfinite(kl):
        raise SystemExit(f"KL(dense||sparse) is not finite: {kl}")
    print("OK")
    return {"kl": kl, "agreement": agree,
            "block_ratios": np.asarray(plan.block_ratios)}


if __name__ == "__main__":
    main()
