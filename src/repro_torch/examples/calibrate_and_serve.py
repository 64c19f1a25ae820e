"""Serving example (the counterpart of the JAX package's
``examples/calibrate_and_serve.py``): calibrate a WiSparse *policy
ladder* offline, save it as one self-contained artifact, reload it in a
"serving fleet" process (no checkpoint needed: the artifact carries
every rung's policy, its ratios/alphas/taus and the shared weight-column
norms g) and serve with the SLO-aware adaptive controller switching
rungs under load.

Lifecycle demonstrated (the README's "Adaptive serving" section):
  1. calibrate  - one calibration context, warm-started evolutionary
                  search per budget rung (paper §4.3 + ladder warm start)
  2. save/load  - one versioned npz for the whole ladder
  3. serve      - pinned-rung quality check through the static-batch
                  loop (``launch/serve.generate``), then the adaptive
                  engine under a request burst (rung switches, no step
                  built after warmup)

    PYTHONPATH=src python -m repro_torch.examples.calibrate_and_serve [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.allocation import EvoConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import api
from repro_torch.serving import Engine, EngineConfig, SLOConfig
from repro_torch.sparsity import PolicyLadder, calibrate_ladder


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.examples.calibrate_and_serve")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is an opt-in)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device=dev)
    data_cfg = DataConfig(cfg.vocab_size, 48, 4)

    # --- 1. offline calibration (one-time, per model) ----------------------
    # One context, three budgets: rung 0 dense, rungs 1-2 warm-started from
    # their denser neighbour (tiny evolutionary budgets for the demo).
    calib = {"tokens": SyntheticLM(data_cfg).batch(0)}
    ladder = calibrate_ladder(
        params, cfg, calib, budgets=(0.0, 0.3, 0.6),
        backend="mask",                 # paper-exact numerics for the demo
        evo=EvoConfig(generations=2, offspring=4, eps=0.1),
        warm_generations=1, delta=0.25, log=print)

    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, "ladder.npz")
        ladder.save(artifact)
        print(f"ladder artifact saved to {artifact}; per-rung block prune "
              "ratios:")
        for b, r in zip(ladder.budgets, ladder.block_ratios):
            print(f"  budget {b:.1f}: {np.round(r, 2)}")

        # --- 2. serving fleet: reload without the calibration context ------
        ladder2 = PolicyLadder.load(artifact, device=dev)
    if ladder2.policies != ladder.policies:
        raise SystemExit("the reloaded ladder's policies differ")

    # --- 3a. pinned-rung quality check vs the dense server -----------------
    prompts = SyntheticLM(dataclasses.replace(data_cfg, seq_len=32)).batch(7)
    dense = generate(params, cfg, prompts, 16, None)
    agreement = {}
    for i in range(1, len(ladder2)):
        pol, sp = ladder2.rung(i)
        sparse = generate(params, cfg, prompts, 16, sp, policy=pol)
        agreement[i] = float((dense == sparse).float().mean())
        print(f"rung {i} (budget {ladder2.budgets[i]:.1f}): "
              f"vs-dense token agreement {agreement[i]:.1%}")

    # --- 3b. adaptive serving: the controller rides the burst --------------
    slo = SLOConfig(tpot_p95=1.0, max_queue=1, dwell=2)   # queue-driven demo
    engine = Engine(params, cfg,
                    EngineConfig(max_slots=2, max_len=48, prefill_chunk=8,
                                 slo=slo),
                    ladder=ladder2, device=dev)       # builds every rung
    burst = SyntheticLM(dataclasses.replace(
        data_cfg, seq_len=16, global_batch=8)).batch(3)
    for b in range(8):
        engine.submit(burst[b], 8)
    out = engine.run()
    print(f"adaptive engine: {sum(len(t) for t in out.values())} tokens, "
          f"controller {engine.controller.snapshot()}, "
          f"decode builds after warmup "
          f"{engine.decode_retraces_after_warmup}")
    return {"agreement": agreement, "tokens": out,
            "controller": engine.controller.snapshot(),
            "builds_after_warmup": engine.decode_retraces_after_warmup}


if __name__ == "__main__":
    main()
